from vaegan_tpu_torch.utils.imaging import make_grid, save_image_grid
from vaegan_tpu_torch.utils.metrics import JsonlSink, MetricsLogger, NeptuneSink, StdoutSink

__all__ = ["MetricsLogger", "StdoutSink", "JsonlSink", "NeptuneSink", "make_grid",
           "save_image_grid"]
