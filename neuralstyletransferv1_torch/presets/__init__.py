"""SQLite presets database — the web gallery's source of truth.

Counterpart of ``neuralstyletransferv1_tpu/presets``: the reference reads
and writes a ``presets.db`` shared with its sibling web repo (reference:
scripts/generate_preset_samples.py:27-210 reads the schema;
scripts/generate_multimodel_presets.py writes 10 categories × 20-30
presets).
"""

from .db import (
    connect,
    create_schema,
    insert_preset,
    load_presets,
    preset_to_argv,
    update_sample_path,
    upsert_category,
)

__all__ = [
    "connect",
    "create_schema",
    "insert_preset",
    "load_presets",
    "preset_to_argv",
    "update_sample_path",
    "upsert_category",
]
