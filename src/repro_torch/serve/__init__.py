from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.pages import PageAllocator, PagedKV
from repro_torch.serve.registry import AdapterRegistry
from repro_torch.serve.spec import NGramDrafter, ScriptedDrafter, SelfDrafter

__all__ = ["AdapterRegistry", "NGramDrafter", "PageAllocator", "PagedKV",
           "ScriptedDrafter", "SelfDrafter", "ServeEngine"]
