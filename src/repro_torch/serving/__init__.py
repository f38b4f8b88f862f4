from repro_torch.serving.engine import InstanceEngine
from repro_torch.serving.request import Phase, Request
from repro_torch.serving.sampling import sample, sample_slots

__all__ = ["InstanceEngine", "Phase", "Request", "sample", "sample_slots"]
