"""Lightweight structured-event hooks for compile provenance.

The compiler tiers (``core.compiler`` / ``core.cg_opt`` /
``core.mapping``) emit small ``(kind, payload)`` events through this
module while they make scheduling decisions — which placement a node
got, how the graph was segmented, whether the compile was served from
cache.  ``obs.explain`` subscribes during a compile to capture
provenance; nothing else in the stack depends on a subscriber being
present.

The design constraint is the emitter's cost when nobody listens: the
compiler's inner loops (``CostModel.placement`` runs once per node per
design point in DSE sweeps) call :func:`emit` unconditionally, so the
disabled path must be one truthiness check on a module-level list —
no allocation, no formatting.  Callers therefore pass cheap payloads
(scalars, short strings) and build anything expensive only when
:func:`subscribed` is true.

Subscribers must not raise: an exception from a hook propagates into
the compile that emitted it (deliberate — silent telemetry loss is
worse during debugging, and subscribers are trusted in-repo code).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

Subscriber = Callable[[str, Dict[str, Any]], None]

#: live subscribers; module-level so ``emit`` is one truthiness check
#: away from free when telemetry is off
_SUBS: List[Subscriber] = []


def subscribe(fn: Subscriber) -> Callable[[], None]:
    """Register ``fn(kind, payload)``; returns an unsubscribe closure."""
    _SUBS.append(fn)

    def unsubscribe() -> None:
        try:
            _SUBS.remove(fn)
        except ValueError:
            pass
    return unsubscribe


def subscribed() -> bool:
    """True when at least one subscriber is live — emitters gate any
    payload construction that is not free on this."""
    return bool(_SUBS)


def emit(kind: str, **payload: Any) -> None:
    """Deliver one event to every subscriber (no-op when none)."""
    if not _SUBS:
        return
    for fn in list(_SUBS):
        fn(kind, payload)
