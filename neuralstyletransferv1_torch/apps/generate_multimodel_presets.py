"""generate_multimodel_presets — populate the presets DB procedurally.

Counterpart of ``neuralstyletransferv1_tpu/apps/generate_multimodel_presets.py``,
a port of the reference generator (reference:
scripts/generate_multimodel_presets.py): 10 categories × 20-30 presets —
blob/tentacle/wave/pulse morphs, static voronoi/radial/spiral/grid
patterns, resolution mixes, and magenta+pytorch/torch7 model mixes. Naming,
category ids, parameter pools and the seeded random draws (seed 42) follow
the reference, so the same seed writes the same rows as the JAX app. It
runs on the host only (sqlite), so it takes no ``--device``.

    python -m neuralstyletransferv1_torch.apps.generate_multimodel_presets --db presets.db
"""

from __future__ import annotations

import argparse
import itertools
import random
import sys

from ..presets import connect, create_schema, insert_preset, upsert_category

MAGENTA_STYLES = [
    f"/app/models/magenta_styles/{n}"
    for n in (
        "canyon.jpg", "starry_night.jpg", "rainbow.jpg", "atoms.jpg",
        "style_rainforest.jpg", "dunes2.jpg", "frame.jpg", "style_gpt.jpg",
        "gpt_style2.jpg", "gpt_style3.jpg", "gptstyle4.jpg", "mountain_geo.jpg",
    )
]
PYTORCH_MODELS = [
    f"/app/models/pytorch/{n}"
    for n in ("candy.pth", "mosaic.pth", "rain_princess.pth", "udnie.pth")
]
TORCH7_MODELS = [
    f"/app/models/torch/{n}"
    for n in ("starry_night_eccv16.t7", "the_scream.t7",
              "composition_vii_eccv16.t7", "la_muse_eccv16.t7")
]

CATEGORIES = [
    (10, "Blob Morph", "Organic blob morphing region effects", 10),
    (11, "Tentacle Morph", "Dynamic tentacle morphing patterns", 11),
    (12, "Wave Morph", "Flowing wave morphing effects", 12),
    (13, "Pulse Morph", "Pulsing radial morph animations", 13),
    (14, "Voronoi Static", "Static voronoi multi-style patterns", 14),
    (15, "Radial Patterns", "Radial burst multi-style effects", 15),
    (16, "Spiral Patterns", "Spiral and concentric patterns", 16),
    (17, "Grid Patterns", "Grid and diagonal style divisions", 17),
    (18, "Resolution Mix", "Mixed resolution magenta styles", 18),
    (19, "Model Mix", "Combining different model types", 19),
]


def short_name(path: str) -> str:
    """(reference: generate_multimodel_presets.py:47-72)"""
    name = path.split("/")[-1].split(".")[0]
    mappings = {
        "canyon": "Canyon", "starry_night": "Starry", "rainbow": "Rainbow",
        "atoms": "Atoms", "style_rainforest": "Forest", "dunes2": "Dunes",
        "frame": "Frame", "style_gpt": "GPT1", "gpt_style2": "GPT2",
        "gpt_style3": "GPT3", "gptstyle4": "GPT4", "mountain_geo": "Geo",
        "candy": "Candy", "mosaic": "Mosaic", "rain_princess": "Rain",
        "udnie": "Udnie",
    }
    return mappings.get(name, name.replace("_", " ").title()[:10])


def _magenta_slots(styles, tiles=None, overlaps=None):
    """Column dict for up to 4 magenta style slots."""
    suffix = ["", "_b", "_c", "_d"]
    cols = {}
    for i, s in enumerate(styles[:4]):
        cols[f"magenta_style{suffix[i]}"] = s
        cols[f"magenta_tile{suffix[i]}"] = tiles[i] if tiles else 512
        cols[f"magenta_overlap{suffix[i]}"] = overlaps[i] if overlaps else 64
    return cols


def gen_blob(conn, cat_id, rng):
    """(reference: :98-126)"""
    combos = list(itertools.combinations(MAGENTA_STYLES[:8], 3))
    rng.shuffle(combos)
    names = []
    for s1, s2, s3 in combos[:25]:
        name = f"Blob {short_name(s1)}-{short_name(s2)}-{short_name(s3)}"
        speed = rng.choice([0.5, 1.0, 1.5, 2.0])
        amp = rng.choice([0.1, 0.15, 0.2, 0.25])
        freq = rng.choice([2.0, 3.0, 4.0])
        insert_preset(
            conn, name=name, description=f"Blob morph with {short_name(s1)}, "
            f"{short_name(s2)}, {short_name(s3)}", category_id=cat_id,
            model_type="magenta", region_mode="voronoi", region_count=3,
            region_feather=30, region_morph=f"{speed},{amp},{freq},blob",
            **_magenta_slots([s1, s2, s3]),
        )
        names.append(name)
    return names


def gen_tentacle(conn, cat_id, rng):
    """(reference: :128-155)"""
    combos = list(itertools.combinations(MAGENTA_STYLES[:8], 4))
    rng.shuffle(combos)
    names = []
    for styles in combos[:25]:
        name = ("Tentacle " + "-".join(short_name(s) for s in styles))[:60]
        speed = rng.choice([0.8, 1.0, 1.2, 1.5])
        amp = rng.choice([0.12, 0.15, 0.18, 0.22])
        freq = rng.choice([2.5, 3.0, 3.5, 4.0])
        insert_preset(
            conn, name=name, description="Tentacle morph quad pattern",
            category_id=cat_id, model_type="magenta", region_mode="voronoi",
            region_count=4, region_feather=25,
            region_morph=f"{speed},{amp},{freq},tentacle",
            **_magenta_slots(list(styles)),
        )
        names.append(name)
    return names


def gen_wave(conn, cat_id, rng):
    """(reference: :157-182)"""
    combos = list(itertools.combinations(MAGENTA_STYLES[:8], 2))
    rng.shuffle(combos)
    names = []
    for s1, s2 in combos[:25]:
        name = f"Wave {short_name(s1)}-{short_name(s2)}"
        speed = rng.choice([0.6, 0.8, 1.0, 1.2])
        amp = rng.choice([0.15, 0.2, 0.25, 0.3])
        freq = rng.choice([1.5, 2.0, 2.5, 3.0])
        insert_preset(
            conn, name=name, description=f"Wave morph duo with {short_name(s1)} "
            f"and {short_name(s2)}", category_id=cat_id, model_type="magenta",
            region_mode="waves", region_count=2, region_feather=40,
            region_morph=f"{speed},{amp},{freq},wave",
            **_magenta_slots([s1, s2]),
        )
        names.append(name)
    return names


def gen_pulse(conn, cat_id, rng):
    """(reference: :184-210)"""
    combos = list(itertools.combinations(MAGENTA_STYLES[:8], 3))
    rng.shuffle(combos)
    names = []
    for s1, s2, s3 in combos[:25]:
        name = f"Pulse {short_name(s1)}-{short_name(s2)}-{short_name(s3)}"
        speed = rng.choice([0.5, 0.7, 1.0, 1.3])
        amp = rng.choice([0.1, 0.15, 0.2])
        freq = rng.choice([2.0, 2.5, 3.0])
        insert_preset(
            conn, name=name, description="Pulse morph radial pattern",
            category_id=cat_id, model_type="magenta", region_mode="radial",
            region_count=3, region_feather=35,
            region_morph=f"{speed},{amp},{freq},pulse",
            **_magenta_slots([s1, s2, s3]),
        )
        names.append(name)
    return names


def gen_voronoi_static(conn, cat_id, rng):
    """(reference: :212-258)"""
    names = []
    idx = 0
    for count in (2, 3, 4, 5, 6):
        combos = list(itertools.combinations(MAGENTA_STYLES[:10], count))
        rng.shuffle(combos)
        for styles in combos[:6]:
            idx += 1
            sn = [short_name(s) for s in styles]
            name = f"VS{idx} {count}x " + "-".join(sn[:2])
            if len(sn) > 2:
                name += f"+{len(sn) - 2}"
            name = name[:60]
            feather = rng.choice([15, 25, 35, 45])
            insert_preset(
                conn, name=name, description=f"Static {count}-style voronoi pattern",
                category_id=cat_id, model_type="magenta", region_mode="voronoi",
                region_count=count, region_feather=feather,
                **_magenta_slots(list(styles)),
            )
            names.append(name)
    return names


def gen_radial(conn, cat_id, rng):
    """(reference: :260-284)"""
    combos = list(itertools.combinations(MAGENTA_STYLES[:8], 3))
    rng.shuffle(combos)
    names = []
    for s1, s2, s3 in combos[:25]:
        name = f"Radial {short_name(s1)}-{short_name(s2)}-{short_name(s3)}"
        insert_preset(
            conn, name=name, description="Radial burst pattern",
            category_id=cat_id, model_type="magenta", region_mode="radial",
            region_count=3, region_feather=rng.choice([20, 30, 40, 50]),
            **_magenta_slots([s1, s2, s3]),
        )
        names.append(name)
    return names


def gen_spiral(conn, cat_id, rng):
    """(reference: :286-313)"""
    combos = list(itertools.combinations(MAGENTA_STYLES[:8], 2))
    rng.shuffle(combos)
    names = []
    for i, (s1, s2) in enumerate(combos[:25]):
        mode = ["spiral", "concentric"][i % 2]
        name = f"{mode.title()} {short_name(s1)}-{short_name(s2)}"
        insert_preset(
            conn, name=name, description=f"{mode.title()} pattern with two styles",
            category_id=cat_id, model_type="magenta", region_mode=mode,
            region_count=rng.choice([2, 3, 4]),
            region_feather=rng.choice([25, 35, 45]),
            **_magenta_slots([s1, s2]),
        )
        names.append(name)
    return names


def gen_grid(conn, cat_id, rng):
    """(reference: :315-343)"""
    combos = list(itertools.combinations(MAGENTA_STYLES[:8], 4))
    rng.shuffle(combos)
    names = []
    for i, styles in enumerate(combos[:25]):
        mode = ["grid", "diagonal"][i % 2]
        name = (f"{mode.title()} " + "-".join(short_name(s) for s in styles))[:60]
        insert_preset(
            conn, name=name, description=f"{mode.title()} pattern with four styles",
            category_id=cat_id, model_type="magenta", region_mode=mode,
            region_count=4, region_feather=rng.choice([15, 25, 35]),
            **_magenta_slots(list(styles)),
        )
        names.append(name)
    return names


def gen_resolution_mix(conn, cat_id, rng):
    """(reference: :345-373)"""
    names = []
    for style in MAGENTA_STYLES[:8]:
        for res in ((256, 512, 1024), (384, 768, 1024), (256, 512, 768)):
            name = (f"ResMix {short_name(style)} "
                    + "-".join(f"{r}px" for r in res))[:60]
            insert_preset(
                conn, name=name,
                description=f"{short_name(style)} at resolutions {res}",
                category_id=cat_id, model_type="magenta", region_mode="voronoi",
                region_count=3, region_feather=30,
                **_magenta_slots([style] * 3, tiles=list(res), overlaps=[32, 64, 128]),
            )
            names.append(name)
            if len(names) >= 25:
                return names
    return names


def gen_model_mix(conn, cat_id, rng):
    """(reference: :375-413)"""
    names = []
    mp = list(itertools.product(MAGENTA_STYLES[:6], PYTORCH_MODELS))
    rng.shuffle(mp)
    for mag, pth in mp[:15]:
        name = f"Mix {short_name(mag)}-{short_name(pth)}"
        insert_preset(
            conn, name=name, description="Magenta + PyTorch model blend",
            category_id=cat_id, model_type="magenta", magenta_style=mag,
            magenta_tile=512, magenta_overlap=64, model_b_type="transformer",
            model_b_path=pth, io_preset_b="auto", region_mode="voronoi",
            region_count=2, region_feather=25, blend_models_weights="0.5,0.5",
        )
        names.append(name)
    mt = list(itertools.product(MAGENTA_STYLES[:6], TORCH7_MODELS))
    rng.shuffle(mt)
    for mag, t7 in mt[:10]:
        name = f"Mix {short_name(mag)}-{short_name(t7)}"
        insert_preset(
            conn, name=name, description="Magenta + Torch7 model blend",
            category_id=cat_id, model_type="magenta", magenta_style=mag,
            magenta_tile=512, magenta_overlap=64, model_b_type="torch7",
            model_b_path=t7, io_preset_b="auto", region_mode="voronoi",
            region_count=2, region_feather=25, blend_models_weights="0.5,0.5",
        )
        names.append(name)
    return names


GENERATORS = [
    ("Blob Morph", gen_blob),
    ("Tentacle Morph", gen_tentacle),
    ("Wave Morph", gen_wave),
    ("Pulse Morph", gen_pulse),
    ("Voronoi Static", gen_voronoi_static),
    ("Radial Patterns", gen_radial),
    ("Spiral Patterns", gen_spiral),
    ("Grid Patterns", gen_grid),
    ("Resolution Mix", gen_resolution_mix),
    ("Model Mix", gen_model_mix),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Populate the presets DB "
                                 "(reference: scripts/generate_multimodel_presets.py)")
    ap.add_argument("--db", default="presets.db")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    rng = random.Random(args.seed)
    conn = connect(args.db)
    create_schema(conn)
    cat_ids = {}
    for cat_id, name, desc, sort in CATEGORIES:
        upsert_category(conn, cat_id, name, desc, sort)
        cat_ids[name] = cat_id
    conn.commit()

    total = 0
    for cat_name, gen in GENERATORS:
        names = gen(conn, cat_ids[cat_name], rng)
        conn.commit()
        print(f"[presets] {cat_name}: {len(names)} presets")
        total += len(names)
    conn.close()
    print(f"[presets] total {total} presets in {args.db}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
