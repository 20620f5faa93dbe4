from repro_torch.runtime.fault_tolerance import StragglerMonitor, TrainRunner

__all__ = ["StragglerMonitor", "TrainRunner"]
