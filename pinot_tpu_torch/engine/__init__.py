"""The query engine: staging, planning, the table kernel, finalize, reduce."""
