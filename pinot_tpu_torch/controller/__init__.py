"""Controller: cluster state, segment store and the REST / control-plane
front (port of ``pinot_tpu.controller``, trimmed to serving offline
tables)."""
