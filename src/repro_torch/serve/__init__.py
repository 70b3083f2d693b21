from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.pages import PageAllocator, PagedKV
from repro_torch.serve.registry import AdapterRegistry

__all__ = ["AdapterRegistry", "PageAllocator", "PagedKV", "ServeEngine"]
