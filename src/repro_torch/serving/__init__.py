from repro_torch.serving.engine import InstanceEngine
from repro_torch.serving.request import Phase, Request

__all__ = ["InstanceEngine", "Phase", "Request"]
