# The bit-sliced crossbar MVM: a hand-written CUDA kernel for Hopper
# (``cim_mvm/kernel.py`` + ``csrc/cim_mvm.cu``), its plain PyTorch
# version (``cim_mvm/ref.py``) and the route registry that picks between
# them per tensor device (``backend``).
from . import backend  # noqa: F401
