"""Realtime ingestion (port of ``pinot_tpu.realtime``): stream providers
(the TCP stream broker, the Kafka wire protocol), mutable segments served
at their row watermark, the LLC completion protocol, the HLC consumer
groups, the ingest pool and backpressure.  Host numpy and threads: only a
query's staging of a consuming segment's snapshot touches the card."""
