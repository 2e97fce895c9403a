"""Tensor parallelism over ``torch.distributed`` (port of
``lite_llama_tpu/parallel/``): process-group start-up and the collectives
(``distributed.py``), the mesh and the sharding policy (``shardings.py``),
and the attention wrappers that hand each rank's kernels its kv heads
(``tp_attention.py``)."""
