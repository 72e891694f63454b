"""SiddhiManager: top-level facade (PyTorch port of
siddhi_tpu/core/manager.py; reference: core/SiddhiManager.java:49).

createSiddhiAppRuntime parses + plans + returns a runtime on the
manager's device. The device defaults to CUDA; without a CUDA device the
manager raises unless the caller asked for the CPU, so a run never falls
back to the CPU silently.
"""
from __future__ import annotations

import torch

from ..lang import ast as A
from ..lang.parser import parse
from .runtime import SiddhiAppRuntime


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. A CUDA device that is not there raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "siddhi_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"siddhi_tpu_torch: unsupported device {dev}")
    return dev


class SiddhiManager:
    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.app_runtimes: dict[str, SiddhiAppRuntime] = {}

    def create_siddhi_app_runtime(self, source,
                                  partition_mesh=None) -> SiddhiAppRuntime:
        if partition_mesh is not None:
            raise NotImplementedError("not ported yet: partition_mesh")
        if isinstance(source, str):
            app_ast = parse(source)
        elif isinstance(source, A.SiddhiApp):
            app_ast = source
        else:
            raise TypeError("expected SiddhiQL text or SiddhiApp")
        rt = SiddhiAppRuntime(app_ast, manager=self, device=self.device)
        self.app_runtimes[rt.name] = rt
        return rt

    def validate_siddhi_app(self, source) -> None:
        """Parse + plan, then discard (reference SiddhiManager.validateSiddhiApp)."""
        app_ast = parse(source) if isinstance(source, str) else source
        SiddhiAppRuntime(app_ast, manager=None, device=self.device)

    def shutdown(self) -> None:
        for rt in list(self.app_runtimes.values()):
            rt.shutdown()
        self.app_runtimes.clear()
