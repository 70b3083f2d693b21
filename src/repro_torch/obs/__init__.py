from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, percentile)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "percentile"]
