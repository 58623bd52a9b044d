"""Token data of the port: the synthetic corpus and the resumable training loader."""

from .tokens import TokenDatasetSpec, TokenLoader, chunk_payload, read_item, read_items

__all__ = ["TokenDatasetSpec", "TokenLoader", "chunk_payload", "read_item", "read_items"]
