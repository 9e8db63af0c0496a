"""The port's distributed query (``cammiq_tpu_torch/parallel``) on the CPU.

- Shard arrays: ``shard_merged_cuts`` and ``build_fused_shard`` against
  the JAX package's, from a MergedIndex and from an artifact.
- Grid runs: ranks over gloo, each a process running this file as its
  worker (``python tests/test_torch_dist.py SPEC``, which imports only
  torch and the port), launched with the environment a launcher sets.
  Their QueryCounts must be bit-identical to the JAX mesh session
  (``QuerySession(..., engine="sortjoin", mesh=make_mesh(dp, mp))`` on
  the 8 CPU devices of the conftest) and to the port's single session.
  A grid session asked for the gather engine runs the sort join, as the
  JAX package's does: distributed query has one design.
- CLI runs: ``-t 2`` and ``--model_shards 2`` as ranks of one world, with
  and without ``--engine gather``; Type-I and Type-II files byte-identical
  to ``cammiq_tpu.cli`` with the same flags, the quant file to the port's
  own single-process file.

Every launch has a wall-clock limit and every process group a timeout, so
a hang fails one test.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cammiq_tpu_torch.query.sortjoin as tsj
from cammiq_tpu_torch import cli
from cammiq_tpu_torch.config import QueryConfig
from cammiq_tpu_torch.index.artifact import load_merged_artifact
from cammiq_tpu_torch.index.table import load_flat_index_pair
from cammiq_tpu_torch.io.fastq import read_fastq
from cammiq_tpu_torch.parallel import dist_query as tdq
from cammiq_tpu_torch.parallel.mesh import ProcessGrid
from cammiq_tpu_torch.parallel.multihost import (host_shard_of_files,
                                                 initialize_cluster)
from cammiq_tpu_torch.query.pipeline import QuerySession
from cammiq_tpu_torch.utils.profiling import trace_path

REPO = Path(__file__).resolve().parent.parent
G = 6                     # 5 genomes + the unassigned slot
BATCH = 2048              # the last of the fixture's two batches leaves
                          # data rank 1 of a (2, .) grid nothing but padding
LAUNCH_TIMEOUT = 240
COUNT_FIELDS = ("cnts_u", "cnts_d", "rcount_u", "rcount_d")
BUILD_FLAGS = ["--both", "-k", "20", "-L", "100", "-Lmax", "40", "-h", "20"]

# small tensors: intra-op threads would only contend with other test workers
torch.set_num_threads(1)


# ---- the worker: one rank of a grid run (no jax, no cammiq_tpu)

def _counts_record(c, sess) -> dict:
    pk = sorted(c.pair_counts.items())
    rec = {f: getattr(c, f) for f in COUNT_FIELDS}
    rec.update(nundet=c.nundet, nconf=c.nconf, num_reads=c.num_reads,
               mean_read_len=c.mean_read_len, maxm=sess.maxm, frac=sess.frac,
               engine=sess.engine,
               pairs=np.asarray([[a, b, n] for (a, b), n in pk], np.int64)
               .reshape(-1, 3))
    return rec


def _worker(spec_path: str) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    initialize_cluster("cpu", timeout=datetime.timedelta(seconds=120))
    rank = torch.distributed.get_rank()
    out = Path(spec["out"])
    grid = ProcessGrid(spec["data"], spec["model"], "cpu")
    toy = spec["toy"]
    if grid.active:
        reads = read_fastq(toy["fq"])
        index_u, index_d = load_flat_index_pair(toy["iu"], toy["idd"])
        artifact = load_merged_artifact(toy["art"])
        cfg = QueryConfig(h=index_u.h, batch_size=BATCH)
        for sc in spec["sessions"]:
            if sc["source"] == "npz":
                sess = QuerySession(index_u, index_d, G, cfg, device="cpu",
                                    grid=grid, engine=sc["engine"])
            else:
                sess = QuerySession.from_artifact(artifact, G, cfg,
                                                  device="cpu", grid=grid)
            floor, slack = tsj.HIT_FLOOR, tsj.LIST_SLACK
            if sc.get("widen"):
                # a match list of 20 rows a batch and one slot a read
                tsj.HIT_FLOOR, tsj.LIST_SLACK = 16, 0
                sess.maxm, sess.frac = 1, 1024
            try:
                c = sess.run(reads, sc_mode=sc["sc"])
            finally:
                tsj.HIT_FLOOR, tsj.LIST_SLACK = floor, slack
            np.savez(out / f"{sc['name']}.rank{rank}.npz",
                     **_counts_record(c, sess), **sess.dist.geometry)
    for argv in spec["cli"]:
        cli.main(argv)          # every rank, the inactive ones too
    torch.distributed.destroy_process_group()


# ---- launching a world of ranks

def _free_ports(n: int) -> list:
    """n distinct free ports (all held open until each is chosen)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _rank_env(rank: int, world: int, port: int) -> dict:
    return dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]),
                OMP_NUM_THREADS="1")


def launch(worlds: dict, timeout=LAUNCH_TIMEOUT) -> dict:
    """Run each ``(world, cmd, dir)`` of ``worlds`` as ranks 0..world-1 of
    its own world, all worlds at once; returns each world's rank logs
    (stdout and stderr).  Every rank must exit 0 within ``timeout``
    seconds."""
    runs = {}
    ports = _free_ports(len(worlds))
    for (key, (world, cmd, tmp)), port in zip(worlds.items(), ports):
        runs[key] = []
        for r in range(world):
            log = open(tmp / f"rank{r}.log", "w+")
            runs[key].append((subprocess.Popen(
                cmd, env=_rank_env(r, world, port), cwd=tmp, stdout=log,
                stderr=subprocess.STDOUT), log))
    procs = [p for ranks in runs.values() for p, _ in ranks]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = {}
    for key, ranks in runs.items():
        logs[key] = []
        for r, (p, log) in enumerate(ranks):
            log.seek(0)
            logs[key].append(log.read())
            log.close()
            assert p.returncode == 0, (f"{key} rank {r} exit {p.returncode}:\n"
                                       f"{logs[key][r][-3000:]}")
    return logs


# ---- the toy: 5 genomes x 2000 bp with segments shared by neighbours

def _hairpin_reads(gs, n=20, seed=4) -> list:
    """Reads x + revcomp(x) of a genome: each matches some entries both
    directly and through their reverse-complement twins, which share the
    entry's id and may sit in another shard."""
    alpha = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(n):
        g = gs[int(rng.integers(len(gs)))]
        p = int(rng.integers(0, len(g) - 50))
        x = g[p:p + 50]
        reads.append(alpha[np.concatenate([x, 3 - x[::-1]])].tobytes())
    return reads


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    from cammiq_tpu.cli import main as jax_cli_main
    from cammiq_tpu.tools.simulate import simulate
    from cammiq_tpu_torch.index.artifact import save_merged_artifact
    from cammiq_tpu_torch.query.merged import build_merged_index
    from torch_fixture import ALPHA, pair_genomes

    root = tmp_path_factory.mktemp("torch_dist")
    gs, _ = pair_genomes(5, glen=2000, seg=300)
    db = root / "fasta"
    db.mkdir()
    with open(root / "genome_map.out", "w") as m:
        for g, x in enumerate(gs):
            s = ALPHA[x].tobytes().decode()
            with open(db / f"genome{g + 1}.fasta", "w") as f:
                f.write(f">g{g + 1} contig1\n")
                f.writelines(s[i:i + 80] + "\n" for i in range(0, len(s), 80))
            m.write(f"genome{g + 1}.fasta\t{g + 1}\t{1000 + g}\tGenome_{g + 1}\n")
    mapf = str(root / "genome_map.out")
    idx = root / "idx"
    iu, idd = str(idx / "index_u.npz"), str(idx / "index_d.npz")
    jax_cli_main(["--build", *BUILD_FLAGS, "-f", mapf, "-D", str(db) + "/",
                  "-i", iu, idd, "--engine", "numpy"])
    fq = str(root / "reads.fq")
    simulate(mapf, str(db), fq, str(root / "truth.out"), num_reads=3000,
             L=100, erate=0.01, dist="uniform", seed=3)
    with open(fq, "a") as f:
        for i, r in enumerate(_hairpin_reads(gs)):
            f.write(f"@hairpin{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")
    index_u, index_d = load_flat_index_pair(iu, idd)
    art = str(root / "merged")
    save_merged_artifact(build_merged_index(index_u, index_d), index_u,
                         index_d, art)
    return dict(root=str(root), mapf=mapf, iu=iu, idd=idd, fq=fq, art=art)


@pytest.fixture(scope="module")
def reads(toy):
    return read_fastq(toy["fq"])


@pytest.fixture(scope="module")
def single(toy, reads):
    """The port's single session in quant and sc mode."""
    index_u, index_d = load_flat_index_pair(toy["iu"], toy["idd"])
    sess = QuerySession(index_u, index_d, G, QueryConfig(h=index_u.h,
                                                         batch_size=BATCH),
                        device="cpu")
    return {sc: sess.run(reads, sc_mode=sc) for sc in (False, True)}


def _jax_counts(toy, reads, sc, mesh=None):
    from cammiq_tpu.config import QueryConfig as JQueryConfig
    from cammiq_tpu.index.table import load_flat_index_pair as jload
    from cammiq_tpu.query.pipeline import QuerySession as JaxSession

    index_u, index_d = jload(toy["iu"], toy["idd"])
    return JaxSession(index_u, index_d, G, JQueryConfig(h=index_u.h,
                                                        batch_size=BATCH),
                      engine="sortjoin", mesh=mesh).run(reads, sc_mode=sc)


def _assert_counts_equal(got: dict, want) -> None:
    for f in COUNT_FIELDS:
        np.testing.assert_array_equal(got[f], getattr(want, f), err_msg=f)
    assert (int(got["nundet"]), int(got["nconf"]), int(got["num_reads"]),
            int(got["mean_read_len"])) == (want.nundet, want.nconf,
                                           want.num_reads, want.mean_read_len)
    pairs = {(int(a), int(b)): int(n) for a, b, n in got["pairs"]}
    assert pairs == want.pair_counts


# ---- shard arrays against the JAX package's

SHARD_ARRAYS = ("erec", "prec", "pref_lo", "pref_hi", "brec", "bloom")


def _cuckoo_set(tab) -> set:
    """(key, start, count) of every filled slot of a 12-word table."""
    t = np.asarray(tab, np.uint32)
    k, s, c = t[:, 0:4].ravel(), t[:, 4:8].ravel(), t[:, 8:12].ravel()
    return set(zip(k[c > 0].tolist(), s[c > 0].tolist(), c[c > 0].tolist()))


def _small_merged():
    """Two unique keys and one doubly key: with their twins, fewer
    buckets than shards at mp = 8, so some shards are empty."""
    from torch_fixture import flat_table

    rng = np.random.default_rng(31)
    u = [list(rng.integers(0, 4, 24)) for _ in range(2)]
    d = [list(rng.integers(0, 4, 22))]
    return flat_table(u, False, 20, 2), flat_table(d, True, 20, 2)


@pytest.mark.parametrize("mp", [1, 2, 3, 8])
@pytest.mark.parametrize("source", ["merged", "artifact", "small"])
def test_shard_arrays_match_jax(toy, tmp_path, monkeypatch, source, mp):
    import cammiq_tpu.query.sortjoin as jsj
    from cammiq_tpu.index.artifact import load_merged_artifact as jload_art
    from cammiq_tpu.parallel import dist_query as jdq
    from cammiq_tpu_torch.query.merged import build_merged_index

    # the JAX package packs its cuckoo table into 8 words at max_bucket <=
    # 8; at 0 it keeps the 12-word rows the port builds for every index
    monkeypatch.setattr(jsj, "BUCKET_SCAN_UNROLL", 0)
    if source == "artifact":
        t_src = tdq._MergedSource.from_artifact(load_merged_artifact(toy["art"]))
        j_src = jdq._MergedSource.from_artifact(jload_art(toy["art"]))
    else:
        if source == "small":
            index_u, index_d = _small_merged()
        else:
            index_u, index_d = load_flat_index_pair(toy["iu"], toy["idd"])
        t_src = tdq._MergedSource.from_merged(build_merged_index(index_u, index_d))
        j_src = jdq._MergedSource.from_merged(jsj.build_merged_index(index_u, index_d))
    cuts = tdq.shard_merged_cuts(t_src, mp)
    jcuts = jdq.shard_merged_cuts(j_src, mp)
    assert cuts == jcuts[:5] + jcuts[6:]          # JAX's also has db
    cuts_b, e_lo, e_hi, e_pad, nb_pad, bloom_log, ck_log = cuts
    empty = 0
    for i in range(mp):
        got = tdq.build_fused_shard(t_src, i, *cuts)
        want, _ = jdq.build_fused_shard(j_src, i, cuts_b, e_lo, e_hi, e_pad,
                                        nb_pad, jcuts[5], bloom_log=bloom_log,
                                        ck_log=ck_log)
        for f in SHARD_ARRAYS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
            assert got[f].dtype == want[f].dtype, f
        assert got["cuckoo"].shape == (1 << ck_log, 12)
        assert _cuckoo_set(got["cuckoo"]) == _cuckoo_set(want["cuckoo"])
        empty += e_hi[i] == e_lo[i]
    assert sum(e_hi[i] - e_lo[i] for i in range(mp)) == t_src.E
    if source == "small" and mp == 8:
        assert empty > 0


def test_host_shard_of_files_matches_jax():
    from cammiq_tpu.parallel.multihost import host_shard_of_files as jshard

    files = [f"r{i}.fq" for i in range(7)]
    assert host_shard_of_files(files) == jshard(files) == files
    assert host_shard_of_files(files, 1, 3) == ["r1.fq", "r4.fq"]
    assert sorted(sum((host_shard_of_files(files, r, 3) for r in range(3)),
                      [])) == sorted(files)


# ---- grid runs over gloo

LAYOUTS = [(2, 1), (1, 2), (2, 2)]
# npzgather: the .npz pair with engine="gather", which a grid runs through
# the sort join
SESSIONS = [dict(name=f"{name}_{'sc' if sc else 'quant'}", source=src,
                 engine=engine, sc=sc)
            for name, src, engine in (("npz", "npz", "sortjoin"),
                                      ("artifact", "artifact", "sortjoin"),
                                      ("npzgather", "npz", "gather"))
            for sc in (False, True)]
# the CLI flags of each layout and its world (3 ranks for (2, 1): one rank
# beyond the grid takes no batches)
CLI_FLAGS = {(2, 1): (["-t", "2"], 3), (1, 2): (["--model_shards", "2"], 2)}
CLI_MODES = {"typeI": ["--read_cnts"], "typeII": ["--read_cnts", "--doubly_unique"],
             "quant": []}
# each CLI mode runs with the default engine and with --engine gather; a
# run's name is its mode, or the mode and "_gather"
CLI_ENGINES = {"": [], "_gather": ["--engine", "gather"]}


def _cli_query(toy, mode, out, *flags):
    return ["--device", "cpu", "--query", *CLI_MODES[mode], "-f", toy["mapf"],
            "-i", toy["iu"], toy["idd"], "-q", toy["fq"], "-e", "0.01",
            "-o", str(out), *flags]


@pytest.fixture(scope="module")
def grid_runs(toy, tmp_path_factory):
    """Every layout's world, launched together once (its session runs and,
    for two layouts, the CLI runs): layout -> (directory, rank logs,
    world size)."""
    worlds = {}
    for dp, mp in LAYOUTS:
        out = tmp_path_factory.mktemp(f"grid_{dp}x{mp}")
        flags, world = CLI_FLAGS.get((dp, mp), ([], dp * mp))
        argvs = []
        for mode in (CLI_MODES if flags else ()):
            for suffix, engine in CLI_ENGINES.items():
                prof = (["--profile", str(out / "prof")]
                        if mode == "typeI" and not suffix else [])
                argvs.append(_cli_query(toy, mode, out / f"{mode}{suffix}.out",
                                        *flags, *engine, *prof))
        spec = dict(out=str(out), data=dp, model=mp, toy=toy,
                    sessions=SESSIONS + [dict(name="widen", source="npz",
                                              engine="sortjoin", sc=False,
                                              widen=True)],
                    cli=argvs)
        with open(out / "spec.json", "w") as f:
            json.dump(spec, f)
        worlds[dp, mp] = (world, [sys.executable, str(Path(__file__).resolve()),
                                  str(out / "spec.json")], out)
    logs = launch(worlds)
    return {k: (out, logs[k], world) for k, (world, _, out) in worlds.items()}


def _rank_records(out: Path, name: str, ranks):
    recs = []
    for r in ranks:
        with np.load(out / f"{name}.rank{r}.npz") as z:
            recs.append({k: z[k] for k in z.files})
    return recs


@pytest.fixture(scope="module")
def jax_mesh_counts(toy, reads):
    from cammiq_tpu.parallel.mesh import make_mesh

    cache = {}

    def get(layout, sc):
        if (layout, sc) not in cache:
            cache[layout, sc] = _jax_counts(toy, reads, sc, make_mesh(*layout))
        return cache[layout, sc]

    return get


@pytest.mark.parametrize("session", [s["name"] for s in SESSIONS])
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
def test_grid_session_matches_jax_mesh(grid_runs, jax_mesh_counts, single,
                                       layout, session):
    """Every rank of the grid ends with the same counts, equal to the JAX
    mesh session's on the same layout and to the port's single session; a
    session asked for the gather engine runs the sort join on the grid."""
    out, _, _ = grid_runs[layout]
    sc = session.endswith("_sc")
    want = jax_mesh_counts(layout, sc)
    recs = _rank_records(out, session, range(layout[0] * layout[1]))
    for rec in recs:
        _assert_counts_equal(rec, want)
        _assert_counts_equal(rec, single[sc])
        assert str(rec["engine"]) == "sortjoin"
    assert want.cnts_u.sum() > 0 and want.cnts_d.sum() > 0
    if sc:
        assert len(want.pair_counts) >= 2
    else:
        assert want.rcount_u.sum() > 0 and want.rcount_d.sum() > 0


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
def test_grid_session_widens(grid_runs, single, layout):
    """From one slot a read and a 20-row match list, every rank widens
    alike from the reduced flags, and the counts still equal the single
    session's."""
    out, _, _ = grid_runs[layout]
    recs = _rank_records(out, "widen", range(layout[0] * layout[1]))
    for rec in recs:
        _assert_counts_equal(rec, single[False])
        assert int(rec["maxm"]) >= 2 and int(rec["frac"]) <= 128
    assert len({(int(r["maxm"]), int(r["frac"])) for r in recs}) == 1


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
def test_grid_shard_geometry(grid_runs, toy, layout):
    """Every rank of a layout derives the same shard shapes, those of
    shard_merged_cuts on the whole index."""
    out, _, _ = grid_runs[layout]
    src = tdq._MergedSource.from_artifact(load_merged_artifact(toy["art"]))
    _, e_lo, e_hi, e_pad, nb_pad, bloom_log, ck_log = \
        tdq.shard_merged_cuts(src, layout[1])
    for rec in _rank_records(out, "artifact_quant", range(layout[0] * layout[1])):
        assert (int(rec["e_pad"]), int(rec["nb_pad"]), int(rec["bloom_log"]),
                int(rec["ck_log"])) == (e_pad, nb_pad, bloom_log, ck_log)
        assert rec["entries"].tolist() == [h - l for l, h in zip(e_lo, e_hi)]


# ---- CLI runs

@pytest.mark.parametrize("mode", ["typeI", "typeII", "typeI_gather",
                                  "typeII_gather"])
@pytest.mark.parametrize("layout", list(CLI_FLAGS), ids=lambda l: f"{l[0]}x{l[1]}")
def test_cli_grid_matches_jax_cli(grid_runs, toy, tmp_path, layout, mode):
    """The grid's Type-I and Type-II files equal ``cammiq_tpu.cli``'s with
    the same flags, ``--engine gather`` among them (both CLIs run a grid
    through the sort join)."""
    from cammiq_tpu.cli import main as jax_cli_main

    out, logs, world = grid_runs[layout]
    flags, _ = CLI_FLAGS[layout]
    base = mode.split("_")[0]
    ref = tmp_path / f"{mode}_jax.out"
    jax_cli_main(_cli_query(toy, base, ref, *flags,
                            *CLI_ENGINES[mode[len(base):]])[2:])
    got = (out / f"{mode}.out").read_bytes()
    assert got == ref.read_bytes()
    assert got.startswith(b"QUERY/TAXID\t1000\t1001")
    dp, mp = layout
    assert f"Distributed query mesh: data={dp} x model={mp}." in logs[0]
    assert all("Distributed query mesh" not in t for t in logs[1:])


@pytest.fixture(scope="module")
def single_quant_file(toy, tmp_path_factory):
    out = tmp_path_factory.mktemp("quant_single") / "quant.out"
    cli.main(_cli_query(toy, "quant", out))
    return out.read_bytes()


@pytest.mark.parametrize("layout,suffix", [
    pytest.param(l, x, id=f"{l[0]}x{l[1]}{x.replace('_', '-')}")
    for x in CLI_ENGINES for l in CLI_FLAGS])
def test_cli_grid_quant_matches_single(grid_runs, single_quant_file, layout,
                                       suffix):
    """The quant file of the grid, with the default engine and with
    ``--engine gather``, equals the port's single-process file; each rank
    of the grid wrote its own profiler trace (of its Type-I run), the rank
    beyond the grid none."""
    out, _, world = grid_runs[layout]
    assert (out / f"quant{suffix}.out").read_bytes() == single_quant_file
    assert single_quant_file.count(b"\n") > 5
    dp, mp = layout
    for r in range(world):
        assert os.path.exists(trace_path(str(out / "prof"), r)) == (r < dp * mp)


def test_cli_t4_without_launcher_runs_single_device(toy, tmp_path, capsys,
                                                    monkeypatch):
    """``-t 4`` with no launcher finds one rank: it says so and writes the
    plain run's file."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    got, ref = tmp_path / "t4.out", tmp_path / "t1.out"
    cli.main(_cli_query(toy, "typeII", got, "-t", "4"))
    assert ("-t 4 requested but only 1 device(s) present; running "
            "single-device.") in capsys.readouterr().err
    cli.main(_cli_query(toy, "typeII", ref))
    assert got.read_bytes() == ref.read_bytes()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("profile", ["", "prof"])
def test_cli_profile_writes_a_trace(toy, tmp_path, profile):
    """``--profile DIR`` traces the query loop into DIR; an empty value
    writes nothing."""
    d = tmp_path / "p"
    flags = ["--profile", str(d) if profile else ""]
    cli.main(_cli_query(toy, "typeI", tmp_path / "o.out", *flags))
    assert os.path.exists(trace_path(str(d))) == bool(profile)
    if profile:
        with open(trace_path(str(d))) as f:
            assert json.load(f)["traceEvents"]


def test_cli_profile_trace_holds_the_program_spans(toy, tmp_path):
    """``--profile DIR``'s trace names the program's spans, the query's
    pass and its batches among them, and the tracer is off after it."""
    from cammiq_tpu_torch.utils.timing import TRACER, take

    d = tmp_path / "p"
    cli.main(_cli_query(toy, "typeI", tmp_path / "o.out", "--profile", str(d)))
    with open(trace_path(str(d))) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"query.run", "query.pass", "pass.stage", "pass.classify",
            "pass.drain"} <= names
    # each with the read set it serves
    sets = {e["args"].get("read_set") for e in events
            if e.get("name", "").startswith(("query.", "pass."))}
    assert len(sets) == 1 and sets.pop()
    assert not TRACER.on and take().spans == []


def test_grid_rejects_a_foreign_backend(tmp_path):
    """A CUDA grid over gloo is refused: there is no fallback."""
    store = torch.distributed.HashStore()
    torch.distributed.init_process_group("gloo", store=store, rank=0,
                                         world_size=1)
    try:
        with pytest.raises(RuntimeError, match="runs on nccl"):
            ProcessGrid(1, 1, "cuda")
        with pytest.raises(ValueError, match="needs 2 ranks"):
            ProcessGrid(2, 1, "cpu")
        assert ProcessGrid(1, 1, "cpu").model_index == 0
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1])
