from . import bm25, rerank, similarity

__all__ = ["bm25", "rerank", "similarity"]
