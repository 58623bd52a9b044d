"""Token data of the port: the synthetic corpus the serving launcher reads prompts from."""

from .tokens import TokenDatasetSpec, chunk_payload, read_item, read_items

__all__ = ["TokenDatasetSpec", "chunk_payload", "read_item", "read_items"]
