# CIM simulators, per §4.1 of the paper: functional (meta-op flow ->
# numerics, op-by-op oracle interpreter + trace-lowered batched
# executor) and performance (cycles / peak power).
#
# Exports resolve lazily (PEP 562) so the compiler's lazy import of
# cimsim.perf does not pull in torch.
_EXPORTS = {
    "FunctionalSimulator": ".functional",
    "VerifyReport": ".functional",
    "compile_and_verify": ".functional",
    "simulate": ".functional",
    "weights_from_reference": ".functional",
    "ExecutorStats": ".executor",
    "LoweredExecutable": ".executor",
    "LoweringError": ".executor",
    "TileRangeError": ".executor",
    "lower": ".executor",
    "FaultModel": ".faults",
    "FaultMap": ".faults",
    "FaultCompileResult": ".faults",
    "fault_aware_compile": ".faults",
    "accuracy_under_faults": ".faults",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        mod = importlib.import_module(_EXPORTS[name], __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
