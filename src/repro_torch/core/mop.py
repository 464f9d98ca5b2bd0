"""Meta-operator flow (§3.3 code generation, Figures 10/11/13/15).

The compiler's output is a *meta-operator flow*: CIM activation operators
(per computing mode), digital-compute operators (DCOM) and data-movement
operators (DMOV), optionally wrapped in ``parallel { }`` blocks.  The BNF
of Figure 10:

    <code>      ::= <operators>* | parallel "{" <operators>* "}"
    <operators> ::= <operators>* <CIM>* <DCOM>* <DMOV>*
    <CIM>       ::= MOP_CM | MOP_XBM | MOP_WLM
    <MOP_CM>    ::= cim.read_core(op, params, core_addr, src, dst)
    <MOP_XBM>   ::= cim.read_xb(xb_addr, len) | cim.write_xb(xb_addr, mat)
    <MOP_WLM>   ::= cim.read_row(row_addr, len) | cim.write_row(row_addr, value)
    <DCOM>      ::= Relu(src,dst,len) | add(src1,src2,dst,len) | ...
    <DMOV>      ::= mov(src,dst,len)

We keep the flow *structured* (dataclasses with attribute dicts) so that
(a) the functional simulator can interpret it, (b) the perf simulator can
cost it, and (c) ``to_text`` emits the paper's concrete syntax.  Large
flows use ``Loop`` compression ("256 similar code segments" in §3.4) —
``expand()`` materializes them for the interpreter.

Users may extend the DCOM vocabulary (paper: "users have the flexibility
to extend meta operators") via ``register_dcom``.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

MOP_CM = {"cim.read_core"}
MOP_XBM = {"cim.read_xb", "cim.write_xb"}
MOP_WLM = {"cim.read_row", "cim.write_row"}
CIM_KINDS = MOP_CM | MOP_XBM | MOP_WLM
DMOV_KINDS = {"mov"}
DCOM_KINDS = {
    "relu", "gelu", "silu", "sigmoid", "tanh", "add", "mul", "shift_acc",
    "maxpool", "avgpool", "softmax", "layernorm", "rmsnorm", "matmul",
    "embedding", "ssm_scan", "rope", "topk_router", "softcap", "identity",
    "transpose", "concat", "split", "flatten", "reshape", "const",
}


def register_dcom(kind: str) -> None:
    """Extend the DCOM meta-operator vocabulary (hardware-defined ops)."""
    DCOM_KINDS.add(kind)


@dataclasses.dataclass
class MetaOp:
    kind: str
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in CIM_KINDS | DMOV_KINDS | DCOM_KINDS:
            raise ValueError(f"unknown meta-operator kind {self.kind!r}")

    @property
    def family(self) -> str:
        if self.kind in CIM_KINDS:
            return "CIM"
        if self.kind in DMOV_KINDS:
            return "DMOV"
        return "DCOM"

    def to_text(self) -> str:
        args = ",".join(f"{k}={_fmt(v)}" for k, v in self.attrs.items()
                        if not k.startswith("_"))
        return f"{self.kind}({args})"


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:g}"
    if isinstance(v, (list, tuple)):
        return "[" + "x".join(str(x) for x in v) + "]"
    return str(v)


@dataclasses.dataclass
class Parallel:
    stmts: List["Stmt"]

    def to_text(self, indent: int = 0) -> str:
        pad = "  " * indent
        inner = "\n".join(_stmt_text(s, indent + 1) for s in self.stmts)
        return f"{pad}parallel {{\n{inner}\n{pad}}}"


@dataclasses.dataclass
class Loop:
    body: List["Stmt"]
    count: int
    note: str = ""

    def to_text(self, indent: int = 0) -> str:
        pad = "  " * indent
        note = f"  // {self.note}" if self.note else ""
        inner = "\n".join(_stmt_text(s, indent + 1) for s in self.body)
        return f"{pad}repeat x{self.count} {{{note}\n{inner}\n{pad}}}"


Stmt = Union[MetaOp, Parallel, Loop]


def _stmt_text(s: Stmt, indent: int) -> str:
    if isinstance(s, MetaOp):
        return "  " * indent + s.to_text()
    return s.to_text(indent)


@dataclasses.dataclass
class Program:
    """A compiled meta-operator flow plus compile-time metadata."""

    name: str
    stmts: List[Stmt]
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_text(self, max_lines: Optional[int] = None) -> str:
        lines: List[str] = [f"// meta-operator flow: {self.name}"]
        for s in self.stmts:
            lines.extend(_stmt_text(s, 0).split("\n"))
            if max_lines and len(lines) > max_lines:
                lines = lines[:max_lines] + ["// ... (truncated)"]
                break
        return "\n".join(lines)

    # -- iteration ---------------------------------------------------------
    def walk(self, expand_loops: bool = False) -> Iterator[MetaOp]:
        yield from _walk(self.stmts, expand_loops)

    def expand(self) -> "Program":
        """Materialize Loop compressions (small programs / interpreter)."""
        return Program(self.name, list(_expand(self.stmts)), dict(self.meta))

    # -- statistics ----------------------------------------------------------
    def op_counts(self, weighted: bool = True) -> Counter:
        c: Counter = Counter()
        _count(self.stmts, 1, c, weighted)
        return c

    def max_parallel_width(self) -> int:
        return _max_width(self.stmts)

    def validate(self) -> None:
        """Structural invariants: known kinds, positive loop counts,
        parallel blocks contain only meta-ops/loops."""
        for op in self.walk(expand_loops=False):
            assert op.kind in CIM_KINDS | DMOV_KINDS | DCOM_KINDS

        def check(stmts: Sequence[Stmt]):
            for s in stmts:
                if isinstance(s, Loop):
                    assert s.count >= 1, "loop count must be >= 1"
                    check(s.body)
                elif isinstance(s, Parallel):
                    assert s.stmts, "empty parallel block"
                    check(s.stmts)

        check(self.stmts)


def _walk(stmts: Sequence[Stmt], expand_loops: bool) -> Iterator[MetaOp]:
    for s in stmts:
        if isinstance(s, MetaOp):
            yield s
        elif isinstance(s, Parallel):
            yield from _walk(s.stmts, expand_loops)
        else:
            reps = s.count if expand_loops else 1
            for _ in range(reps):
                yield from _walk(s.body, expand_loops)


def _expand(stmts: Sequence[Stmt]) -> Iterator[Stmt]:
    for s in stmts:
        if isinstance(s, Loop):
            for _ in range(s.count):
                yield from _expand(s.body)
        elif isinstance(s, Parallel):
            yield Parallel(list(_expand(s.stmts)))
        else:
            yield s


def _count(stmts: Sequence[Stmt], mult: int, c: Counter, weighted: bool):
    for s in stmts:
        if isinstance(s, MetaOp):
            c[s.kind] += mult
        elif isinstance(s, Parallel):
            _count(s.stmts, mult, c, weighted)
        else:
            _count(s.body, mult * (s.count if weighted else 1), c, weighted)


def _max_width(stmts: Sequence[Stmt]) -> int:
    best = 1
    for s in stmts:
        if isinstance(s, Parallel):
            best = max(best, sum(1 for _ in _walk(s.stmts, False)))
            best = max(best, _max_width(s.stmts))
        elif isinstance(s, Loop):
            best = max(best, _max_width(s.body))
    return best


# -- convenience constructors (paper syntax) ---------------------------------

def read_core(op: str, core_addr: int, src: int, dst: int, **kw) -> MetaOp:
    return MetaOp("cim.read_core", dict(op=op, core_addr=core_addr,
                                        src=src, dst=dst, **kw))


def write_xb(xb_addr: Any, mat: Any, **kw) -> MetaOp:
    return MetaOp("cim.write_xb", dict(xb_addr=xb_addr, mat=mat, **kw))


def read_xb(xb_addr: Any, length: int = 1, **kw) -> MetaOp:
    return MetaOp("cim.read_xb", dict(xb_addr=xb_addr, len=length, **kw))


def write_row(row_addr: Any, value: Any, **kw) -> MetaOp:
    return MetaOp("cim.write_row", dict(row_addr=row_addr, value=value, **kw))


def read_row(row_addr: Any, length: int, **kw) -> MetaOp:
    return MetaOp("cim.read_row", dict(row_addr=row_addr, len=length, **kw))


def mov(src: Any, dst: Any, length: int, **kw) -> MetaOp:
    return MetaOp("mov", dict(src=src, dst=dst, len=length, **kw))


def dcom(kind: str, **kw) -> MetaOp:
    return MetaOp(kind, kw)
