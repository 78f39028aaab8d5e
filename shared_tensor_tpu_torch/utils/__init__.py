"""Timing and profiling helpers of the port (``timing.py``, ``profiling.py``)
and checkpoint / resume (``checkpoint.py``), as ``shared_tensor_tpu.utils``
exports it."""

__all__ = ["checkpoint"]


def __getattr__(name):
    # imported on first use: checkpoint.py imports the pod tier, whose
    # parallel/ici.py imports utils.timing from this package
    if name == "checkpoint":
        import importlib

        return importlib.import_module(f"{__name__}.checkpoint")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
