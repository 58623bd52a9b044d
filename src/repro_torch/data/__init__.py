"""Token data of the port: the corpus striped into the Hoard cache, its seeded
oracle, and the resumable training loader that reads it through the store."""

from .tokens import (
    TokenDatasetSpec,
    TokenLoader,
    chunk_payload,
    materialize_token_dataset,
    read_item,
    read_items,
)

__all__ = ["TokenDatasetSpec", "TokenLoader", "chunk_payload", "materialize_token_dataset",
           "read_item", "read_items"]
