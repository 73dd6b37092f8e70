"""The port's host modules: the job queue (``parallel/jobqueue.py``), the
presets DB (``presets/db.py``), ``drive_videos``' queue and static-shard
modes and ``generate_multimodel_presets``: the twins of
``tests/test_jobqueue.py`` (all nine cases) and ``tests/test_presets.py``'s
DB cases, with the port held equal to the JAX package where both compute
the same thing (the populated rows, ``preset_to_argv``, ``shard_static``).
No tensor is computed here: every comparison is exact.

JAX and torch are imported inside the tests: the concurrent-claim case
spawns workers that import this module.
"""

import json
import multiprocessing as mp
import os
import time
from pathlib import Path

import pytest

from neuralstyletransferv1_torch.parallel.jobqueue import JobQueue, default_worker_id, shard_static


def test_shard_static_partition():
    items = [f"v{i}" for i in range(10)]
    shards = [shard_static(items, k, 3) for k in range(3)]
    flat = sorted(x for s in shards for x in s)
    assert flat == sorted(items)
    assert all(len(s) in (3, 4) for s in shards)
    with pytest.raises(ValueError):
        shard_static(items, 3, 3)
    from neuralstyletransferv1_tpu.parallel import jobqueue as jq

    for n in (1, 2, 3, 4, 7):
        assert [shard_static(items, k, n) for k in range(n)] == \
            [jq.shard_static(items, k, n) for k in range(n)]
    assert default_worker_id() == jq.default_worker_id()


def test_enqueue_claim_complete(tmp_path):
    q = JobQueue(tmp_path / "q")
    a = q.enqueue({"video": "a.mp4"}, job_id="a")
    q.enqueue({"video": "b.mp4"}, job_id="b")
    assert a == "a"
    assert q.counts() == {"pending": 2, "running": 0, "done": 0, "failed": 0}

    jid, rec = q.claim("w1")
    assert jid == "a" and rec["video"] == "a.mp4" and rec["_worker"] == "w1"
    q.complete(jid, {"frames": 10})
    jid2, _ = q.claim("w1")
    q.complete(jid2)
    assert q.claim("w1") is None
    assert q.drained()
    done = json.loads((tmp_path / "q" / "done" / "a.json").read_text())
    assert done["_result"] == {"frames": 10}


def test_enqueue_unique_idempotent(tmp_path):
    q = JobQueue(tmp_path / "q")
    assert q.enqueue_unique({"v": 1}, "x") is True
    assert q.enqueue_unique({"v": 1}, "x") is False
    jid, _ = q.claim()
    q.complete(jid)
    # still in done/: re-running the enqueue on another host adds nothing
    assert q.enqueue_unique({"v": 1}, "x") is False


def test_fail_retry_budget(tmp_path):
    q = JobQueue(tmp_path / "q")
    q.enqueue({"v": 1}, "j")
    for k in range(2):
        jid, rec = q.claim()
        assert rec["_retries"] == k
        q.fail(jid, "boom", retry=True, max_retries=2)
    jid, rec = q.claim()
    assert rec["_retries"] == 2 and rec["_last_error"] == "boom"
    q.fail(jid, "boom again", retry=True, max_retries=2)  # budget exhausted
    assert q.counts()["failed"] == 1
    assert json.loads((tmp_path / "q" / "failed" / "j.json").read_text())["_error"]


def test_requeue_stale(tmp_path):
    q = JobQueue(tmp_path / "q")
    q.enqueue({"v": 1}, "s")
    jid, _ = q.claim("dead-worker")
    p = tmp_path / "q" / "running" / "s.json"
    old = time.time() - 100
    os.utime(p, (old, old))
    assert q.requeue_stale(stale_secs=50) == ["s"]
    jid2, rec = q.claim("live-worker")
    assert jid2 == "s" and rec["_retries"] == 1
    q.heartbeat(jid2)  # a fresh heartbeat is not requeued
    assert q.requeue_stale(stale_secs=50) == []


def _claim_worker(root, out_file):
    q = JobQueue(root)
    got = []
    while True:
        c = q.claim()
        if c is None:
            break
        got.append(c[0])
        q.complete(c[0])
    Path(out_file).write_text(json.dumps(got))


def test_concurrent_claim_exclusivity(tmp_path):
    """4 processes claiming at once partition the jobs exactly."""
    q = JobQueue(tmp_path / "q")
    jobs = [q.enqueue({"i": i}) for i in range(40)]

    ctx = mp.get_context("spawn")
    outs = [tmp_path / f"w{k}.json" for k in range(4)]
    procs = [ctx.Process(target=_claim_worker, args=(str(tmp_path / "q"), str(o)))
             for o in outs]
    for p in procs:
        p.start()
    for p in procs:
        p.join(60)
        assert p.exitcode == 0
    claimed = [j for o in outs for j in json.loads(o.read_text())]
    assert sorted(claimed) == sorted(jobs)  # every job exactly once
    assert q.drained() and q.counts()["done"] == 40


def test_work_loop(tmp_path):
    q = JobQueue(tmp_path / "q")
    for i in range(5):
        q.enqueue({"i": i})
    seen = []
    n = q.work(lambda rec: seen.append(rec["i"]) or {"ok": True}, worker="w", poll_secs=0.01)
    assert n == 5 and sorted(seen) == list(range(5))
    q.enqueue({"i": 99}, "bad")  # a raising job retries, then fails; the loop drains

    def fn(rec):
        raise RuntimeError("nope")

    q.work(fn, worker="w", poll_secs=0.01)
    assert q.counts()["failed"] == 1


def _videos(vid_dir, names, n):
    import cv2
    import numpy as np

    vid_dir.mkdir()
    rng = np.random.default_rng(0)
    for name in names:
        vw = cv2.VideoWriter(str(vid_dir / name), cv2.VideoWriter_fourcc(*"mp4v"), 8, (32, 24))
        for _ in range(n):
            vw.write((rng.random((24, 32, 3)) * 255).astype(np.uint8))
        vw.release()


def test_drive_videos_queue_mode(tmp_path, monkeypatch):
    """QUEUE_DIR enqueues a job a video and drains them; a second (late)
    run finds nothing left. ``probe_duration_seconds`` reads the clip's
    length through OpenCV."""
    pytest.importorskip("cv2")
    from neuralstyletransferv1_torch.apps import drive_videos as dv

    _videos(tmp_path / "in", ("a.mp4", "b.mp4"), 4)
    assert dv.probe_duration_seconds(tmp_path / "in" / "a.mp4") == pytest.approx(0.5)
    processed = []
    monkeypatch.setattr(dv, "_run_chunk", lambda vid, env: processed.append(vid.name))
    monkeypatch.setenv("DEVICE", "cpu")
    monkeypatch.setenv("IN_DIR", str(tmp_path / "in"))
    monkeypatch.setenv("OUT_DIR", str(tmp_path / "out"))
    monkeypatch.setenv("QUEUE_DIR", str(tmp_path / "queue"))
    monkeypatch.setenv("MODELS", "pytorch:/nonexistent/x.pth")
    monkeypatch.setenv("CHUNK_STRATEGY", "chunk")

    assert dv.main([]) == 0
    assert sorted(processed) == ["a.mp4", "b.mp4"]
    assert JobQueue(tmp_path / "queue").counts()["done"] == 2
    processed.clear()
    assert dv.main([]) == 0
    assert processed == []


def test_drive_videos_static_shard(tmp_path, monkeypatch):
    pytest.importorskip("cv2")
    from neuralstyletransferv1_torch.apps import drive_videos as dv

    _videos(tmp_path / "in", ("a.mp4", "b.mp4", "c.mp4"), 3)
    monkeypatch.setenv("DEVICE", "cpu")
    monkeypatch.setenv("IN_DIR", str(tmp_path / "in"))
    monkeypatch.setenv("OUT_DIR", str(tmp_path / "out"))
    monkeypatch.setenv("MODELS", "pytorch:/nonexistent/x.pth")
    monkeypatch.delenv("QUEUE_DIR", raising=False)
    got = {}
    for host in range(2):
        processed = []
        monkeypatch.setattr(dv, "_run_chunk", lambda vid, env: processed.append(vid.name))
        monkeypatch.setenv("NUM_HOSTS", "2")
        monkeypatch.setenv("HOST_ID", str(host))
        assert dv.main([]) == 0
        got[host] = processed
    assert sorted(got[0] + got[1]) == ["a.mp4", "b.mp4", "c.mp4"]
    assert got[0] and got[1]


def test_drive_videos_plans_match_jax(tmp_path):
    """The planner's pure parts equal the JAX app's: the chunk plans of the
    four strategies, the slot env of a chunk, the random plan."""
    from neuralstyletransferv1_torch.apps import drive_videos as dv
    from neuralstyletransferv1_tpu.apps import drive_videos as jdv

    models = dv.parse_models_env("pytorch:a,torch7:b.t7,magenta:s.jpg,c,reconet:r,pytorch:d")
    assert models == jdv.parse_models_env("pytorch:a,torch7:b.t7,magenta:s.jpg,c,reconet:r,"
                                          "pytorch:d")
    dirs = ("/p", "/t", "/m", "/ms")
    for strategy in ("chunk", "clamp4", "pad", "bogus"):
        plan = dv.plan_chunks(models, strategy)
        assert plan == jdv.plan_chunks(models, strategy)
        assert [dv.slot_env_for_chunk(c, dirs) for c in plan] == \
            [jdv.slot_env_for_chunk(c, dirs) for c in plan]
    for n in range(1, 8):
        assert dv.equal_weights_csv(n) == jdv.equal_weights_csv(n)
    pms, tms = [Path(f"/p/m{i}.pth") for i in range(3)], [Path(f"/t/t{i}.t7") for i in range(2)]
    styles = [Path(f"/ms/s{i}.jpg") for i in range(4)]
    for vid in ("clip.mp4", "other.mov"):
        assert dv.random_plan(vid, pms, tms, styles, True, "/m") == \
            jdv.random_plan(vid, pms, tms, styles, True, "/m")


@pytest.fixture(scope="module")
def populated_dbs(tmp_path_factory):
    """The same seed through the port's and the JAX app's generator."""
    from neuralstyletransferv1_torch.apps.generate_multimodel_presets import main
    from neuralstyletransferv1_tpu.apps.generate_multimodel_presets import main as jmain

    d = tmp_path_factory.mktemp("db")
    assert main(["--db", str(d / "port.db")]) == 0
    assert jmain(["--db", str(d / "jax.db")]) == 0
    return d / "port.db", d / "jax.db"


def test_populate_and_load(populated_dbs):
    from neuralstyletransferv1_torch.presets import load_presets

    presets = load_presets(populated_dbs[0])
    assert len(presets) >= 200  # 10 categories × 20-30 presets
    assert {"Blob Morph", "Tentacle Morph", "Wave Morph", "Pulse Morph", "Voronoi Static",
            "Radial Patterns", "Spiral Patterns", "Grid Patterns", "Resolution Mix",
            "Model Mix"} <= {p["category"] for p in presets}
    blob = next(p for p in presets if p["category"] == "Blob Morph")
    assert blob["params"]["model_type"] == "magenta"
    assert blob["params"]["region_mode"] == "voronoi"
    assert blob["params"]["region_morph"].endswith("blob")
    mix = next(p for p in presets if p["category"] == "Model Mix")
    assert mix["params"]["blend_models_weights"] == "0.5,0.5"


def test_populate_is_seeded_and_matches_jax(populated_dbs, tmp_path):
    """The same seed writes the same rows, in the port and against JAX's
    generator (every column of every table)."""
    import sqlite3

    from neuralstyletransferv1_torch.apps.generate_multimodel_presets import main
    from neuralstyletransferv1_torch.presets import load_presets

    db2 = tmp_path / "again.db"
    assert main(["--db", str(db2)]) == 0

    def rows(p):
        with sqlite3.connect(str(p)) as c:
            return {t: c.execute(f"SELECT * FROM {t} ORDER BY rowid").fetchall()
                    for t in ("categories", "presets", "tags", "preset_tags")}

    assert rows(populated_dbs[0]) == rows(populated_dbs[1]) == rows(db2)
    assert load_presets(populated_dbs[0]) == load_presets(db2)
    assert main(["--db", str(tmp_path / "s7.db"), "--seed", "7"]) == 0
    assert rows(tmp_path / "s7.db")["presets"] != rows(db2)["presets"]


def test_preset_to_argv_matches_jax_and_parses(populated_dbs):
    """``preset_to_argv`` equals JAX's on every populated preset, and every
    flag it emits parses under the port's CLI."""
    from neuralstyletransferv1_torch.engine.pipeline import build_parser
    from neuralstyletransferv1_torch.presets import load_presets, preset_to_argv
    from neuralstyletransferv1_tpu.presets import preset_to_argv as jargv

    assert preset_to_argv({"model": "x.pth", "blend_models_lab": True, "region_count": 3,
                           "flow_ema": False}) == \
        ["--model", "x.pth", "--blend_models_lab", "--region_count", "3"]
    parser = build_parser()
    presets = load_presets(populated_dbs[0])
    for p in presets:
        argv = preset_to_argv(p["params"])
        assert argv == jargv(p["params"]), p["name"]
        parser.parse_args(["--input_image", "a.png", "--output_image", "b.png"] + argv)
    assert any("--region_morph" in preset_to_argv(p["params"]) for p in presets)


def test_schema_update_sample_path(tmp_path):
    """``update_sample_path`` records a sample; ``load_presets`` then
    returns it, and a missing DB raises."""
    from neuralstyletransferv1_torch.presets import (connect, create_schema, insert_preset,
                                                     load_presets, update_sample_path,
                                                     upsert_category)

    db = tmp_path / "p.db"
    conn = connect(db)
    create_schema(conn)
    upsert_category(conn, 1, "C", "d", 1)
    pid = insert_preset(conn, name="x", category_id=1, model_path="m.pth", flow_ema=1,
                        blend=0.0)
    conn.commit()
    update_sample_path(conn, pid, "/s/x.jpg")
    conn.close()
    (p,) = load_presets(db)
    assert p["sample_image"] == "/s/x.jpg" and p["category"] == "C"
    assert p["params"] == {"model": "m.pth", "flow_ema": True, "blend": 0.0}
    with pytest.raises(FileNotFoundError):
        load_presets(tmp_path / "missing.db")
