from .ops import ssd_chunked
from .ref import ssd_chunked_ref, ssd_intra_chunk_ref, ssd_sequential_ref

__all__ = ["ssd_chunked", "ssd_chunked_ref", "ssd_intra_chunk_ref",
           "ssd_sequential_ref"]
