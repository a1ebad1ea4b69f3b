from .ops import gather_pages, scatter_pages
from .ref import gather_pages_ref, scatter_pages_ref

__all__ = ["gather_pages", "scatter_pages", "gather_pages_ref",
           "scatter_pages_ref"]
