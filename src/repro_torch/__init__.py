"""PyTorch/CUDA port of the CIM-MLC compile-then-execute stack.

Layout mirrors the JAX package ``repro``: ``core`` (compiler passes),
``cimsim`` (interpreter, trace-lowered executor, performance model),
``kernels`` (the bit-sliced crossbar MVM: a hand-written CUDA kernel for
Hopper plus its plain PyTorch version), ``serving`` (``CimBatchService``
and the fleet), ``dse`` (design-space exploration), ``workloads`` and
``obs``.  The package imports ``torch`` and ``numpy`` only.

Entry points that execute take ``device=`` and default to ``"cuda"``;
without a card they raise unless the caller passes ``device="cpu"``.
"""
