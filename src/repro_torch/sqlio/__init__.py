from repro_torch.sqlio.schema import build_schema, load_embedding_matrix, insert_chunks
from repro_torch.sqlio.presets import run_preset, PRESETS

__all__ = [
    "build_schema",
    "load_embedding_matrix",
    "insert_chunks",
    "run_preset",
    "PRESETS",
]
