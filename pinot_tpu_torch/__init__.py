"""pinot_tpu_torch — the PyTorch/CUDA port of pinot_tpu's query data plane.

One server answers PQL aggregation and group-by queries over immutable
segments on one NVIDIA H100 (or on the CPU when the caller asks for it):
parse -> optimize -> ``engine.executor.QueryExecutor.execute`` ->
``engine.reduce.reduce_to_response``.  The fused filtered group-by runs in
a hand-written CUDA kernel (``csrc/fused_groupby.cu``).

The package imports torch, numpy and the standard library only; the JAX
package ``pinot_tpu`` is the reference it is tested against and is never
imported from here.
"""
