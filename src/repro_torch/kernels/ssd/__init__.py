from .grad import ssd_intra_chunk_vjp
from .ops import SsdIntraChunkFn, ssd_chunked, ssd_intra_chunk
from .ref import ssd_chunked_ref, ssd_intra_chunk_ref, ssd_sequential_ref

__all__ = ["SsdIntraChunkFn", "ssd_chunked", "ssd_chunked_ref", "ssd_intra_chunk",
           "ssd_intra_chunk_ref", "ssd_intra_chunk_vjp", "ssd_sequential_ref"]
