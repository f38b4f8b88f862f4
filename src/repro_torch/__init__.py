"""AcceLLM serving on PyTorch and CUDA for one NVIDIA H100.

A port of the JAX package ``repro`` that grows beside it slice by slice and
is held against it on the same inputs.  It imports ``torch`` and ``numpy``
only.  Prefill attention, paged and dense decode attention and the Mamba
selective scan run in CUDA C++ kernels written for Hopper (``csrc/``), each
with a plain PyTorch version beside it.

Entry points (:func:`repro_torch.api.serve`,
:class:`repro_torch.scheduling.LiveCluster`,
:class:`repro_torch.serving.InstanceEngine`,
:func:`repro_torch.models.init_params`, :func:`repro_torch.models.init_state`,
:class:`repro_torch.kvstore.PagedStore`) run on ``device="cuda"`` unless the
caller passes another device, and raise where there is no card.
"""
