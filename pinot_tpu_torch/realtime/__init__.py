"""Realtime ingestion (port of ``pinot_tpu.realtime``, the LLC half):
stream providers, mutable segments served at their row watermark, the
completion protocol, the ingest pool and backpressure, and the TCP
stream broker.  Host numpy and threads: only a query's staging of a
consuming segment's snapshot touches the card."""
