"""Content-addressed compile cache — a shared artifact store.

Entries are keyed by ``core.compiler.compile_key`` — a SHA-256 over the
graph structure, the full Abs-arch description and every scheduling knob
— so a key can only ever map to one compilation output.  Each entry is
three files under ``<root>/v<schema>/<key[:2]>/``:

  * ``<key>.pkl``   — the pickled ``CompileResult`` (plan + program);
  * ``<key>.json``  — the small ``PerfReport.metrics()`` bundle, so sweep
    re-runs score cached points without unpickling multi-MB plans;
  * ``<key>.src``   — the short ``owner`` token of the handle that
    published the entry, so a hit can be attributed to the campaign (or
    fleet) that paid the compile.

Writes are atomic (tempfile + ``os.replace``), which makes *publication*
safe under any number of concurrent writers — sweep-runner process
pools, simultaneous campaigns, serving fleets warm-loading from the same
root.  Invalidation is by construction: changing the graph, the arch,
any knob, or ``COMPILE_KEY_SCHEMA`` (bumped when compiler passes change
behaviour) changes the key; stale entries are simply never addressed
again.  ``clear()`` removes the directory tree.

Disk growth is bounded when ``max_bytes`` is set: after each ``put`` the
current schema's entries are LRU-evicted by access time until the total
size fits (the entry just written is never evicted).  Eviction holds an
exclusive **lock file** (``<root>/v<schema>/.lock``, ``flock`` where
available, an ``O_EXCL`` spin lock elsewhere), so two handles — or two
processes — capping the same store serialize their scans instead of
deleting each other's in-flight entries; ``evict_grace_s`` additionally
exempts entries younger than the grace window.  Long-running fleets and
campaign farms set the cap; the default stays unbounded so sweep
reproducibility never silently loses entries.

Cross-process accounting: every handle carries an ``owner`` token; disk
hits on entries another handle published count as ``foreign_hits``
(the cross-campaign reuse the shared store exists for), and
``publish_stats()`` / ``shared_stats()`` aggregate per-handle counter
bundles across processes through the store itself.

The store is this package's own: its default root
(``~/.cache/repro-cim-mlc-torch/compile``) and its environment variable
(``REPRO_TORCH_COMPILE_CACHE_DIR``) differ from the JAX package's, whose
keys are the same.  An entry whose pickle names a module of ``repro`` or
``jax`` (one the JAX package wrote, under a root the caller shared) is
refused with :class:`ForeignEntryError` rather than unpickled, which
would import that package, or recompiled in silence.
"""
from __future__ import annotations

import contextlib
import json
import os
import pickle
import tempfile
import time
import uuid
from pathlib import Path
from typing import Dict, Iterator, Optional

from ..core.compiler import COMPILE_KEY_SCHEMA, CompileResult
from ..obs import metrics as obs_metrics

#: environment override for the on-disk cache location
CACHE_DIR_ENV = "REPRO_TORCH_COMPILE_CACHE_DIR"

#: top-level packages a cached pickle must not name: unpickling their
#: classes would import the JAX package, and JAX with it
FOREIGN_PACKAGES = ("repro", "jax", "jaxlib")

#: spin-lock parameters for the no-``fcntl`` fallback (seconds): poll
#: backoff doubles deterministically from _LOCK_POLL_S up to
#: _LOCK_POLL_MAX_S (no jitter — retry schedules must replay exactly),
#: and markers older than _LOCK_STALE_S are presumed abandoned by a
#: dead process and broken
_LOCK_POLL_S = 0.005
_LOCK_POLL_MAX_S = 0.25
_LOCK_STALE_S = 30.0


class CacheLockTimeout(TimeoutError):
    """The store lock could not be acquired within ``timeout_s``.

    Raised instead of blocking forever when a caller bounds the wait —
    a holder that is alive but slow (not stale) keeps the lock, and the
    caller decides whether to retry, skip maintenance, or surface the
    contention."""


class ForeignEntryError(RuntimeError):
    """A cached pickle names a class of the JAX package (or of JAX).

    Raised by ``CompileCache.get`` instead of importing that package or
    quietly recompiling: the store's root is shared with the JAX
    package's, which the caller has to fix."""


class _PortUnpickler(pickle.Unpickler):
    """Unpickler that refuses every global of ``FOREIGN_PACKAGES``."""

    def __init__(self, f, path: Path):
        super().__init__(f)
        self._path = path

    def find_class(self, module: str, name: str):
        if module.split(".")[0] in FOREIGN_PACKAGES:
            raise ForeignEntryError(
                f"compile cache entry {self._path} holds {module}.{name}: "
                "it was written by the JAX package; give this package a "
                f"root of its own (${CACHE_DIR_ENV})")
        return super().find_class(module, name)


def default_cache_dir() -> Path:
    env = os.environ.get(CACHE_DIR_ENV)
    if env:
        return Path(env)
    xdg = os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))
    return Path(xdg) / "repro-cim-mlc-torch" / "compile"


class CompileCache:
    """Disk-backed compile cache with an in-process memory layer.

    The memory layer serves repeated compiles inside one process without
    touching disk; ``memory=False`` disables it (useful for measuring the
    disk path, and for workers that should not grow resident memory).

    ``owner`` names this handle in the shared store (default: a random
    token per handle).  Two campaigns sharing one root pass distinct
    owners (or accept the default) and read ``stats()["foreign_hits"]``
    to see how many artifacts the *other* campaign paid for.
    """

    def __init__(self, root=None, memory: bool = True,
                 max_bytes: Optional[int] = None,
                 owner: Optional[str] = None,
                 evict_grace_s: float = 0.0):
        self.root = Path(root) if root is not None else default_cache_dir()
        self._mem: Optional[Dict[str, CompileResult]] = {} if memory else None
        self._mem_metrics: Dict[str, Dict] = {}
        self.max_bytes = max_bytes   # on-disk size cap (None: unbounded)
        self.evict_grace_s = float(evict_grace_s)
        self._disk_total: Optional[int] = None   # running size estimate
        self._access: Dict[str, float] = {}      # per-key last hit (any layer)
        self.owner = owner if owner else uuid.uuid4().hex[:12]
        self._origin_seen: set = set()  # keys whose disk origin was counted
        self.hits = 0           # full CompileResult hits (get)
        self.metrics_hits = 0   # metric-only hits (get_metrics, no unpickle)
        self.misses = 0         # lookups of either kind that found nothing
        self.evictions = 0      # entries removed by the size cap
        self.foreign_hits = 0   # disk hits on entries another owner wrote

    # -- paths ------------------------------------------------------------
    @property
    def _base(self) -> Path:
        return self.root / f"v{COMPILE_KEY_SCHEMA}"

    def _dir(self, key: str) -> Path:
        return self._base / key[:2]

    def _pkl(self, key: str) -> Path:
        return self._dir(key) / f"{key}.pkl"

    def _json(self, key: str) -> Path:
        return self._dir(key) / f"{key}.json"

    def _src(self, key: str) -> Path:
        return self._dir(key) / f"{key}.src"

    # -- locking ----------------------------------------------------------
    @contextlib.contextmanager
    def lock(self, timeout_s: Optional[float] = None,
             stale_s: Optional[float] = None,
             force_spin: bool = False) -> Iterator[None]:
        """Exclusive store-wide lock.

        Guards multi-file maintenance — eviction uses it internally.
        Prefer ``flock`` (kernel-released on process death); fall back to
        an ``O_EXCL`` spin lock where ``fcntl`` is missing.  Publication
        (``put``) does *not* take the lock: atomic renames are already
        safe under concurrency.

        ``timeout_s`` bounds the wait on either path — ``None`` blocks
        until acquired, otherwise :class:`CacheLockTimeout` is raised
        once the deadline passes.  The spin path polls with a
        deterministic exponential backoff (``_LOCK_POLL_S`` doubling to
        ``_LOCK_POLL_MAX_S``, no jitter) and breaks markers older than
        ``stale_s`` (default ``_LOCK_STALE_S``) — a crashed holder never
        wedges the store, unlike a naive O_EXCL loop.  ``force_spin``
        selects the marker path even when ``fcntl`` exists, so the
        fallback is testable on platforms that have ``flock``.
        """
        self._base.mkdir(parents=True, exist_ok=True)
        fcntl = None
        if not force_spin:
            try:
                import fcntl
            except ImportError:
                fcntl = None
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        if fcntl is not None:
            with open(self._base / ".lock", "a+b") as f:
                if deadline is None:
                    fcntl.flock(f.fileno(), fcntl.LOCK_EX)
                else:
                    poll = _LOCK_POLL_S
                    while True:
                        try:
                            fcntl.flock(f.fileno(),
                                        fcntl.LOCK_EX | fcntl.LOCK_NB)
                            break
                        except OSError:
                            if time.monotonic() >= deadline:
                                raise CacheLockTimeout(
                                    f"store lock at {self._base} not "
                                    f"acquired within {timeout_s}s") from None
                            time.sleep(poll)
                            poll = min(poll * 2, _LOCK_POLL_MAX_S)
                try:
                    yield
                finally:
                    fcntl.flock(f.fileno(), fcntl.LOCK_UN)
            return
        # portable fallback: spin on an exclusive-create marker
        marker = self._base / ".lock.excl"
        stale = _LOCK_STALE_S if stale_s is None else stale_s
        poll = _LOCK_POLL_S
        while True:
            try:
                fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                try:     # holder identity, for post-mortem diagnostics
                    os.write(fd, f"{self.owner} pid={os.getpid()}".encode())
                finally:
                    os.close(fd)
                break
            except FileExistsError:
                try:   # break locks abandoned by a dead process
                    if time.time() - marker.stat().st_mtime > stale:
                        marker.unlink(missing_ok=True)
                        continue
                except OSError:
                    continue   # holder released between open and stat
                if deadline is not None and time.monotonic() >= deadline:
                    raise CacheLockTimeout(
                        f"store lock at {marker} not acquired within "
                        f"{timeout_s}s") from None
                time.sleep(poll)
                poll = min(poll * 2, _LOCK_POLL_MAX_S)
        try:
            yield
        finally:
            try:
                marker.unlink()
            except OSError:
                pass

    # -- lookups ----------------------------------------------------------
    def _touch(self, key: str) -> None:
        """Record a hit for the size cap's LRU: memory-layer hits never
        reach the files, so disk atimes alone would rank the *hottest*
        entries oldest — this per-handle access map keeps them safe."""
        if self.max_bytes is not None:
            self._access[key] = time.time()

    def _count_origin(self, key: str) -> None:
        """Attribute a *disk* hit to the handle that published the entry.

        Counted once per key per handle (the first disk load; memory-layer
        re-hits are this handle's own amortization, not cross-handle
        reuse).  Entries without a ``.src`` sidecar (pre-upgrade stores)
        stay unattributed.
        """
        if key in self._origin_seen:
            return
        self._origin_seen.add(key)
        try:
            writer = self._src(key).read_text(encoding="utf-8").strip()
        except OSError:
            return
        if writer and writer != self.owner:
            self.foreign_hits += 1
            obs_metrics.count("compile_cache_foreign_hits_total")

    def get(self, key: str) -> Optional[CompileResult]:
        """Full ``CompileResult`` for ``key``, or None."""
        if self._mem is not None and key in self._mem:
            self.hits += 1
            obs_metrics.count("compile_cache_hits_total", layer="memory")
            self._touch(key)
            return self._mem[key]
        path = self._pkl(key)
        try:
            with open(path, "rb") as f:
                result = _PortUnpickler(f, path).load()
        except ForeignEntryError:
            raise
        except Exception:
            # missing file, truncated write, or a stale entry whose classes
            # changed shape under it (AttributeError/ImportError from
            # pickle): all degrade to a recompute, never an abort
            self.misses += 1
            obs_metrics.count("compile_cache_misses_total")
            return None
        self.hits += 1
        obs_metrics.count("compile_cache_hits_total", layer="disk")
        self._touch(key)
        self._count_origin(key)
        if self._mem is not None:
            self._mem[key] = result
        return result

    def get_metrics(self, key: str) -> Optional[Dict]:
        """Metric bundle only — the cheap warm-sweep path (no unpickling)."""
        if key in self._mem_metrics:
            self.metrics_hits += 1
            obs_metrics.count("compile_cache_metrics_hits_total",
                              layer="memory")
            self._touch(key)
            return dict(self._mem_metrics[key])
        try:
            with open(self._json(key)) as f:
                metrics = json.load(f)
        except (OSError, json.JSONDecodeError):
            self.misses += 1
            obs_metrics.count("compile_cache_misses_total")
            return None
        self.metrics_hits += 1
        obs_metrics.count("compile_cache_metrics_hits_total", layer="disk")
        self._touch(key)
        self._count_origin(key)
        self._mem_metrics[key] = metrics
        return dict(metrics)

    def contains(self, key: str) -> bool:
        if self._mem is not None and key in self._mem:
            return True
        return self._pkl(key).exists()

    # -- stores -----------------------------------------------------------
    def put(self, key: str, result: CompileResult,
            metrics: Optional[Dict] = None) -> None:
        if metrics is None:
            metrics = result.metrics()
        self._dir(key).mkdir(parents=True, exist_ok=True)
        _atomic_write(self._pkl(key),
                      pickle.dumps(result, pickle.HIGHEST_PROTOCOL))
        _atomic_write(self._json(key),
                      json.dumps(metrics, sort_keys=True).encode())
        _atomic_write(self._src(key), self.owner.encode())
        self._origin_seen.add(key)        # own entry: never a foreign hit
        if self._mem is not None:
            self._mem[key] = result
        self._mem_metrics[key] = metrics
        if self.max_bytes is not None:
            # keep put O(1) while the cap is far away: maintain a running
            # size estimate (seeded by one full scan) and rescan/evict
            # only when it crosses the cap.  Writes by other handles are
            # invisible until a threshold scan, so the cap is enforced
            # per handle, not as a cross-process hard limit.
            if self._disk_total is None:
                self._disk_total = self.disk_bytes()
            else:
                for p in (self._pkl(key), self._json(key), self._src(key)):
                    try:
                        self._disk_total += p.stat().st_size
                    except OSError:
                        pass
            if self._disk_total > self.max_bytes:
                self._evict(keep=key)

    # -- maintenance ------------------------------------------------------
    def _entry_paths(self, pkl: Path):
        return [pkl, pkl.with_suffix(".json"), pkl.with_suffix(".src")]

    def disk_bytes(self) -> int:
        """Total bytes of the current schema's on-disk entries."""
        if not self._base.exists():
            return 0
        total = 0
        for pkl in self._base.glob("*/*.pkl"):
            for p in self._entry_paths(pkl):
                try:
                    total += p.stat().st_size
                except OSError:
                    pass
        return total

    def _evict(self, keep: Optional[str] = None) -> None:
        """Lock-guarded LRU-by-atime eviction down to ``max_bytes``.

        The whole scan-and-delete runs under the store lock (``lock()``),
        so concurrent cappers — another campaign, a serving fleet — never
        interleave their scans and evict each other's in-flight entries;
        each waits its turn and re-measures the store it actually sees.
        Entries younger than ``evict_grace_s`` are exempt, so a writer's
        freshly published artifacts survive a neighbour's eviction pass
        even before that writer reads them back.

        Each entry's recency is the newest of its files' access times
        (``get`` reads the pkl, ``get_metrics`` the json) and this
        handle's in-process hit log (``_touch`` — memory-layer hits
        never touch the files, so without it the hottest entries would
        rank oldest).  On noatime/relatime mounts the on-disk component
        degrades toward write time, turning cross-handle recency into
        LRU-by-insertion — still bounded, just less precise.  The
        just-written ``keep`` entry is never evicted, so a cap smaller
        than one entry keeps exactly the newest.  Evicted keys are also
        dropped from the memory layer, keeping ``contains``/``get``
        consistent with the disk state.  The scan's recount re-seeds the
        running ``_disk_total`` estimate, so drift from overwrites or
        concurrent writers self-corrects here.
        """
        if not self._base.exists():
            self._disk_total = 0
            return
        with self.lock():
            self._evict_locked(keep)

    def _evict_locked(self, keep: Optional[str]) -> None:
        now = time.time()
        entries = []    # (recency, key, size, paths, fresh)
        total = 0
        for pkl in self._base.glob("*/*.pkl"):
            key = pkl.stem
            paths = self._entry_paths(pkl)
            size = recency = 0
            for p in paths:
                try:
                    st = p.stat()
                except OSError:
                    continue
                size += st.st_size
                recency = max(recency, st.st_atime, st.st_mtime)
            fresh = now - recency < self.evict_grace_s
            recency = max(recency, self._access.get(key, 0.0))
            entries.append((recency, key, size, paths, fresh))
            total += size
        if total > self.max_bytes:
            entries.sort(key=lambda e: (e[0], e[1]))   # oldest access first
            for _, key, size, paths, fresh in entries:
                if total <= self.max_bytes:
                    break
                if key == keep or fresh:
                    continue
                for p in paths:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
                if self._mem is not None:
                    self._mem.pop(key, None)
                self._mem_metrics.pop(key, None)
                self._access.pop(key, None)
                total -= size
                self.evictions += 1
                obs_metrics.count("compile_cache_evictions_total")
        self._disk_total = total

    def drop_memory(self) -> None:
        """Forget the in-process layer (keeps disk entries)."""
        if self._mem is not None:
            self._mem.clear()
        self._mem_metrics.clear()

    def clear(self) -> None:
        """Delete every entry of the current schema from disk + memory."""
        import shutil
        self.drop_memory()
        self._disk_total = None
        shutil.rmtree(self._base, ignore_errors=True)

    # -- accounting -------------------------------------------------------
    def _counters(self) -> Dict[str, int]:
        return {"hits": self.hits, "metrics_hits": self.metrics_hits,
                "misses": self.misses, "evictions": self.evictions,
                "foreign_hits": self.foreign_hits}

    def stats(self) -> Dict[str, int]:
        """Hit/miss counters for this handle plus the on-disk entry count.

        ``hits`` are full ``CompileResult`` lookups served, and
        ``metrics_hits`` the metric-only lookups that answered without
        unpickling a plan (the warm-sweep fast path); ``misses`` counts
        lookups of either kind that found nothing.  ``foreign_hits``
        counts disk hits on entries *another* owner published — the
        cross-campaign reuse a shared store exists for.  Campaign
        summaries surface this bundle (``CampaignResult.cache_stats``)."""
        disk = 0
        if self._base.exists():
            disk = sum(1 for _ in self._base.glob("*/*.pkl"))
        out = self._counters()
        out["disk_entries"] = disk
        return out

    def publish_stats(self) -> Path:
        """Publish this handle's counters into the shared store.

        Writes ``<root>/v<schema>/_stats/<owner>.json`` atomically
        (cumulative counters — re-publishing overwrites, it never double
        counts), so ``shared_stats`` can aggregate every participating
        campaign/fleet without any of them talking to each other.
        """
        d = self._base / "_stats"
        d.mkdir(parents=True, exist_ok=True)
        payload = dict(self._counters(), owner=self.owner, time=time.time())
        path = d / f"{self.owner}.json"
        _atomic_write(path, json.dumps(payload, sort_keys=True).encode())
        return path

    def shared_stats(self) -> Dict[str, int]:
        """Aggregate counters across every handle that published.

        This handle's *live* counters are included even if it has not
        published yet; ``owners`` counts the distinct participants.
        """
        return shared_stats(self.root, extra=[dict(self._counters(),
                                                   owner=self.owner)])

    def __repr__(self) -> str:
        return (f"CompileCache(root={str(self.root)!r}, "
                f"owner={self.owner!r}, max_bytes={self.max_bytes})")


def shared_stats(root, extra=None) -> Dict[str, int]:
    """Sum the per-owner counter bundles published under ``root``.

    ``extra`` (internal) merges live, not-yet-published handle counters;
    a published bundle for the same owner is superseded by its live one.
    """
    base = Path(root) / f"v{COMPILE_KEY_SCHEMA}" / "_stats"
    by_owner: Dict[str, Dict] = {}
    if base.exists():
        for p in sorted(base.glob("*.json")):
            try:
                with open(p) as f:
                    by_owner[p.stem] = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
    for bundle in (extra or []):
        by_owner[bundle["owner"]] = bundle
    keys = ("hits", "metrics_hits", "misses", "evictions", "foreign_hits")
    out = {k: 0 for k in keys}
    for bundle in by_owner.values():
        for k in keys:
            out[k] += int(bundle.get(k, 0))
    out["owners"] = len(by_owner)
    return out


def _atomic_write(path: Path, data: bytes) -> None:
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
