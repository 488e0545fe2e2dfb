"""covalent_tpu_plugin_torch: the PyTorch and CUDA port of covalent_tpu_plugin.

A Covalent electron is dispatched through :class:`GPUExecutor`; the worker
harness runs it on an NVIDIA card.  Ported so far: the training path (the
transformer LM (:class:`TransformerLM`, :func:`lm_125m_config`), its losses
and train step, and flash attention (:func:`flash_attention`) whose forward
and two backward sweeps are hand-written CUDA kernels for Hopper (``csrc/``),
built with ``nvcc`` at first use, never at import), and the serving path
(``models.decode``: the KV cache and ``generate``; ``models.serve``: the
continuous-batching engine and the ``serve_lm`` electron), the resident
serving session (``serving.open_session``), the MNIST workloads
(``models.mlp``, ``models.train.train_mnist``) and the workflow layer
(``workflow``: ``@electron(executor="gpu")``, ``@lattice``, ``dispatch``),
and scale-out (``parallel``: meshes, FSDP2 and tensor parallelism over a
``torch.distributed`` gang that ``GPUExecutor(workers=[...])`` launches).

Entry points run on the card unless the caller passes ``device="cpu"``.
Nothing here imports JAX or the reference package.
"""

from .gpu import GPUExecutor
from .models.transformer import TransformerLM, lm_125m_config
from .ops.attention import flash_attention

__all__ = ["GPUExecutor", "TransformerLM", "flash_attention", "lm_125m_config"]
