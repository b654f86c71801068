from repro_torch.embed.hashing import HashEmbedder

__all__ = ["HashEmbedder"]
