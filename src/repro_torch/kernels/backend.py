"""Route registry: which crossbar-MVM implementation runs, on what device.

Every CIM kernel entry point has two execution routes:

  * ``compiled`` — the hand-written CUDA kernel (``csrc/cim_mvm.cu``,
                   built for ``sm_90a``); runs on CUDA tensors of a
                   Hopper card only,
  * ``torch``    — the plain PyTorch version (``cim_mvm/ref.py``); runs on
                   any device, and is the semantic ground truth.

Callers ask the registry for a :class:`KernelRoute` (``resolve``); the
registry decides from the device the tensors live on.  ``supports`` and
``capability_matrix`` say what can run where without resolving a call.  Auto resolution
takes ``compiled`` on a Hopper CUDA device and ``torch`` on the CPU; it
never takes ``torch`` on a CUDA device, so a CUDA tensor either reaches
the kernel or raises.  Overrides exist at two levels, highest first:

  * per-call: ``cim_mvm(..., mode="torch")``,
  * environment: ``REPRO_TORCH_KERNEL_MODE=compiled|torch|auto``.

The environment variable is the port's own: the JAX package's
``REPRO_KERNEL_MODE`` is never read here.  Asking for a combination that
cannot run (``compiled`` on the CPU) raises ``KernelUnsupportedError``;
nothing in the port turns that into a fallback.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch

#: execution routes, in "fast on the card" order
MODES = ("compiled", "torch")
AUTO = "auto"

_ENV_MODE = "REPRO_TORCH_KERNEL_MODE"

#: the platform whose CUDA devices run the compiled route (sm_90a build)
HOPPER = "cuda"


class KernelUnsupportedError(RuntimeError):
    """The requested (kernel, mode, platform) combination cannot run."""


class KernelArgumentError(RuntimeError):
    """A kernel wrapper was handed tensors it cannot launch on: the wrong
    device, dtype, shape or layout.  A ``RuntimeError``, like every fault
    of the kernel path, so no caller that reports ``ValueError`` as an
    infeasible design point can take it for one."""


@dataclasses.dataclass(frozen=True)
class KernelCapability:
    """Per-kernel support matrix: the kernel is built for Hopper only;
    the ``torch`` route runs everywhere."""

    name: str

    def modes_on(self, platform: str) -> Tuple[str, ...]:
        if platform == HOPPER:
            return ("compiled", "torch")
        return ("torch",)


#: one entry per public kernel entry point
REGISTRY: Dict[str, KernelCapability] = {
    name: KernelCapability(name)
    for name in ("cim_mvm", "cim_mvm_tiles", "cim_mvm_signed")}


@dataclasses.dataclass(frozen=True)
class KernelRoute:
    """One resolved routing decision: *this* kernel runs *this* way."""

    kernel: str
    platform: str
    mode: str            # "compiled" | "torch"
    reason: str = ""


# -- devices -----------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless told otherwise.

    Raises when a CUDA device is asked for (explicitly or by default) and
    none is available — the port never carries on on the CPU unless the
    caller passes ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU")
    return dev


def detect_platform(device) -> str:
    """``"cpu"``, ``"cuda"`` (a Hopper card, which the kernel is built
    for) or ``"sm_XY"`` for another CUDA architecture."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    major, minor = torch.cuda.get_device_capability(dev)
    return HOPPER if major == 9 else f"sm_{major}{minor}"


def _requested_mode(mode: Optional[str]) -> str:
    """Resolution order: per-call > environment > auto."""
    want = mode or os.environ.get(_ENV_MODE, "").strip().lower() or AUTO
    if want not in MODES and want != AUTO:
        raise ValueError(f"unknown kernel mode {want!r}; "
                         f"expected one of {MODES + (AUTO,)}")
    return want


# -- resolution --------------------------------------------------------------

def _platform(device, platform: Optional[str]) -> str:
    """The named ``platform``, else that of ``device`` (default the card)."""
    return platform or detect_platform(resolve_device(device))


def supports(kernel: str, mode: str, platform: Optional[str] = None) -> bool:
    """True if ``kernel`` can execute via ``mode`` on ``platform``
    (default: the card's)."""
    return mode in REGISTRY[kernel].modes_on(_platform(None, platform))


def resolve(kernel: str, mode: Optional[str] = None, *, device=None,
            platform: Optional[str] = None) -> KernelRoute:
    """Decide how ``kernel`` runs for tensors on ``device`` (or on the
    named ``platform``, which resolution-only callers may pass instead).
    Without either, the device is the card, as for every entry point
    (``resolve_device``).

    Auto policy: ``compiled`` where the platform has the kernel, the
    plain version on the CPU, and an error on a CUDA device without the
    kernel.  Raises :class:`KernelUnsupportedError` if a forced mode
    cannot run.
    """
    if kernel not in REGISTRY:
        raise KeyError(f"unknown kernel {kernel!r}; "
                       f"registered: {sorted(REGISTRY)}")
    want = _requested_mode(mode)
    platform = _platform(device, platform)
    avail = REGISTRY[kernel].modes_on(platform)
    if want == AUTO:
        if "compiled" in avail:
            return KernelRoute(kernel, platform, "compiled",
                               f"auto: {platform} runs the CUDA kernel")
        if platform == "cpu":
            return KernelRoute(kernel, platform, "torch",
                               "auto: CPU tensors take the plain version")
        raise KernelUnsupportedError(
            f"{kernel}: no kernel is built for {platform!r}; pass "
            "mode='torch' to run the plain version there explicitly")
    if want not in avail:
        raise KernelUnsupportedError(
            f"{kernel}: mode {want!r} is not supported on {platform!r} "
            f"(available: {avail})")
    return KernelRoute(kernel, platform, want, "explicitly requested")


def capability_matrix(platform: Optional[str] = None) -> Dict[str, Dict]:
    """Docs view: per kernel, the modes each platform supports and the
    route auto-resolution picks on ``platform`` (default: the card's;
    ``None`` where auto resolution refuses, as on a non-Hopper card)."""
    platform = _platform(None, platform)
    out: Dict[str, Dict] = {}
    for name, cap in REGISTRY.items():
        try:
            auto = resolve(name, mode=AUTO, platform=platform).mode
        except KernelUnsupportedError:
            auto = None
        out[name] = {
            "platforms": {p: cap.modes_on(p) for p in ("cpu", HOPPER)},
            "auto_mode": auto,
        }
    return out
