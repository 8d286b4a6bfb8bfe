"""Hardware profiles (copy of ``repro/hw/profiles.py``) and the PyTorch
calibration pass that measures a device's effective rates."""

from repro_torch.hw.calibration import CalibrationResult, calibrate
from repro_torch.hw.profiles import (ALL_INSTANCES, AWS_INSTANCES,
                                     TPU_INSTANCES, DeviceProfile,
                                     InstanceProfile, effective,
                                     get_instance, paper_cluster)

__all__ = [
    "ALL_INSTANCES", "AWS_INSTANCES", "TPU_INSTANCES", "DeviceProfile",
    "InstanceProfile", "effective", "get_instance", "paper_cluster",
    "CalibrationResult", "calibrate",
]
