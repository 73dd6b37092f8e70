"""Presets SQLite schema + loaders.

Counterpart of ``neuralstyletransferv1_tpu/presets/db.py`` (the port's own
copy). The schema is reconstructed from the reference's consumers and
producers — the SELECT at scripts/generate_preset_samples.py:41-90 and the
INSERTs at scripts/generate_multimodel_presets.py:92-410 (the reference's
own schema.sql is an empty file). ``load_presets`` reproduces the
reference's column→param mapping exactly (generate_preset_samples.py:
94-190), and ``preset_to_argv`` emits only flags of the port's own CLI
(``engine/config.py``), so a preset drives the port's engine with the same
flags as the JAX engine.
"""

from __future__ import annotations

import sqlite3
from pathlib import Path

_SCHEMA = """
CREATE TABLE IF NOT EXISTS categories (
    id INTEGER PRIMARY KEY,
    name TEXT NOT NULL UNIQUE,
    description TEXT,
    sort_order INTEGER DEFAULT 0
);
CREATE TABLE IF NOT EXISTS presets (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL,
    description TEXT,
    category_id INTEGER REFERENCES categories(id),
    model_type TEXT,
    model_path TEXT,
    io_preset TEXT,
    magenta_style TEXT,
    magenta_tile INTEGER,
    magenta_overlap INTEGER,
    blend REAL,
    smooth_alpha REAL,
    smooth_lightness INTEGER,
    smooth_chroma INTEGER,
    chroma_alpha REAL,
    flow_ema INTEGER,
    flow_alpha REAL,
    model_b_type TEXT,
    model_b_path TEXT,
    io_preset_b TEXT,
    magenta_style_b TEXT,
    magenta_tile_b INTEGER,
    magenta_overlap_b INTEGER,
    model_c_type TEXT,
    model_c_path TEXT,
    io_preset_c TEXT,
    magenta_style_c TEXT,
    magenta_tile_c INTEGER,
    magenta_overlap_c INTEGER,
    model_d_type TEXT,
    model_d_path TEXT,
    io_preset_d TEXT,
    magenta_style_d TEXT,
    magenta_tile_d INTEGER,
    magenta_overlap_d INTEGER,
    blend_models_weights TEXT,
    blend_models_lab INTEGER,
    blend_models_lab_weights TEXT,
    region_mode TEXT,
    region_count INTEGER,
    region_feather INTEGER,
    region_blend_spec TEXT,
    region_morph TEXT,
    region_rotate REAL,
    region_sizes TEXT,
    sample_image_path TEXT
);
CREATE TABLE IF NOT EXISTS tags (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL UNIQUE
);
CREATE TABLE IF NOT EXISTS preset_tags (
    preset_id INTEGER REFERENCES presets(id),
    tag_id INTEGER REFERENCES tags(id),
    PRIMARY KEY (preset_id, tag_id)
);
"""


def connect(db_path: str | Path) -> sqlite3.Connection:
    conn = sqlite3.connect(str(db_path))
    conn.row_factory = sqlite3.Row
    return conn


def create_schema(conn: sqlite3.Connection) -> None:
    conn.executescript(_SCHEMA)
    conn.commit()


def upsert_category(conn, cat_id: int, name: str, description: str, sort_order: int):
    conn.execute(
        "INSERT OR REPLACE INTO categories (id, name, description, sort_order) "
        "VALUES (?, ?, ?, ?)",
        (cat_id, name, description, sort_order),
    )


def insert_preset(conn, **cols) -> int:
    names = ", ".join(cols)
    qs = ", ".join("?" * len(cols))
    cur = conn.execute(f"INSERT INTO presets ({names}) VALUES ({qs})", list(cols.values()))
    return cur.lastrowid


def update_sample_path(conn, preset_id: int, sample_path: str) -> None:
    conn.execute("UPDATE presets SET sample_image_path = ? WHERE id = ?",
                 (sample_path, preset_id))
    conn.commit()


# (column, param-name, kind) — kind: '' plain, 'bool', 'notnull' (emit when
# not None vs truthy), mirroring reference generate_preset_samples.py:94-190.
_PARAM_COLS = [
    ("model_type", "model_type", ""),
    ("model_path", "model", ""),
    ("io_preset", "io_preset", ""),
    ("magenta_style", "magenta_style", ""),
    ("magenta_tile", "magenta_tile", ""),
    ("magenta_overlap", "magenta_overlap", "notnull"),
    ("blend", "blend", "notnull"),
    ("smooth_alpha", "smooth_alpha", "notnull"),
    ("smooth_lightness", "smooth_lightness", "bool"),
    ("smooth_chroma", "smooth_chroma", "bool"),
    ("chroma_alpha", "chroma_alpha", "notnull"),
    ("flow_ema", "flow_ema", "bool"),
    ("flow_alpha", "flow_alpha", "notnull"),
    ("model_b_type", "model_b_type", ""),
    ("model_b_path", "model_b", ""),
    ("io_preset_b", "io_preset_b", ""),
    ("magenta_style_b", "magenta_style_b", ""),
    ("magenta_tile_b", "magenta_tile_b", ""),
    ("magenta_overlap_b", "magenta_overlap_b", "notnull"),
    # NOTE: the reference SELECT reads slot B's magenta tile/overlap and
    # slots C/D's model columns only — magenta_style_c/d and tile/overlap
    # c/d are WRITTEN by generate_multimodel_presets but never read back
    # (generate_preset_samples.py:41-90); mirrored here.
    ("model_c_type", "model_c_type", ""),
    ("model_c_path", "model_c", ""),
    ("io_preset_c", "io_preset_c", ""),
    ("model_d_type", "model_d_type", ""),
    ("model_d_path", "model_d", ""),
    ("io_preset_d", "io_preset_d", ""),
    ("blend_models_weights", "blend_models_weights", ""),
    ("blend_models_lab", "blend_models_lab", "bool"),
    ("blend_models_lab_weights", "blend_models_lab_weights", ""),
    ("region_mode", "region_mode", ""),
    ("region_count", "region_count", ""),
    ("region_feather", "region_feather", ""),
    ("region_blend_spec", "region_blend_spec", ""),
    ("region_morph", "region_morph", ""),
    ("region_rotate", "region_rotate", "notnull"),
    ("region_sizes", "region_sizes", ""),
]


def load_presets(db_path: str | Path) -> list[dict]:
    """All presets as {id, name, description, category, params, tags[,
    sample_image]} dicts (reference: generate_preset_samples.py:30-198)."""
    db_path = Path(db_path)
    if not db_path.exists():
        raise FileNotFoundError(f"presets.db not found at {db_path}")
    conn = connect(db_path)
    cur = conn.execute("""
        SELECT p.*, c.name AS category, GROUP_CONCAT(t.name) AS tags
        FROM presets p
        LEFT JOIN categories c ON p.category_id = c.id
        LEFT JOIN preset_tags pt ON p.id = pt.preset_id
        LEFT JOIN tags t ON pt.tag_id = t.id
        GROUP BY p.id
        ORDER BY p.id
    """)
    out = []
    for row in cur.fetchall():
        params = {}
        for col, param, kind in _PARAM_COLS:
            v = row[col]
            if kind == "bool":
                if v:
                    params[param] = bool(v)
            elif kind == "notnull":
                if v is not None:
                    params[param] = v
            else:
                if v:
                    params[param] = v
        preset = {
            "id": row["id"],
            "name": row["name"],
            "description": row["description"],
            "category": row["category"],
            "params": params,
            "tags": row["tags"].split(",") if row["tags"] else [],
        }
        if row["sample_image_path"]:
            preset["sample_image"] = row["sample_image_path"]
        out.append(preset)
    conn.close()
    return out


_ENGINE_FLAGS: set | None = None


def _engine_flags() -> set:
    global _ENGINE_FLAGS
    if _ENGINE_FLAGS is None:
        from ..engine.config import build_arg_parser

        _ENGINE_FLAGS = {
            s.lstrip("-") for a in build_arg_parser()._actions for s in a.option_strings
        }
    return _ENGINE_FLAGS


def preset_to_argv(params: dict) -> list[str]:
    """params dict → engine CLI argv fragment (reference build_command flag
    mapping, generate_preset_samples.py:322-411 — in-process, no subprocess).

    Params without a matching engine flag are dropped, as the reference's
    build_command does (it forwards a fixed flag list; DB-only columns like
    magenta_tile_b never reach the CLI)."""
    flags = _engine_flags()
    argv: list[str] = []
    for key, val in params.items():
        if key not in flags:
            continue
        if isinstance(val, bool):
            if val:
                argv.append(f"--{key}")
        else:
            argv += [f"--{key}", str(val)]
    return argv
