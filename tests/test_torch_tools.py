"""The port's genome-database tools (``cammiq_tpu_torch/tools/preprocess.py``
and ``download.py``) against their sources in ``cammiq_tpu/tools/``: the
cases of ``tests/test_tools.py`` run through both packages on the same
files, outputs compared.  Nothing is fetched: ``urlretrieve`` raises in
every case, and the taxonomy and assembly summaries are local files."""

import os
import urllib.request

import pytest

import cammiq_tpu
import cammiq_tpu.tools.download as jdl
import cammiq_tpu.tools.preprocess as jpp
import cammiq_tpu_torch
import cammiq_tpu_torch.tools.download as tdl
import cammiq_tpu_torch.tools.preprocess as tpp

PP = {"port": tpp, "jax": jpp}
DL = {"port": tdl, "jax": jdl}

MAP = (
    "g1.fna\t1\t100\tAlpha one\n"
    "g2.fna\t2\t200\tBeta two\n"
    "g3.fna\t2\t200\tBeta two\n"
)


@pytest.fixture(autouse=True)
def no_fetch(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError(f"urlretrieve called: {a}")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


def write(path, text):
    with open(path, "w") as f:
        f.write(text)


def read(path):
    with open(path) as f:
        return f.read()


def _preprocess_steps(mod, d):
    """tests/test_tools.py's add/del/merge/sort sequence in directory d;
    every file it writes, by name."""
    mp, out, m2, merged, mp3 = (os.path.join(d, n) for n in
                                ("map.out", "out.out", "map2.out", "merged.out",
                                 "map3.out"))
    write(mp, MAP)
    write(m2, "g1.fna\t1\t111\tOther alpha\ng9.fna\t2\t900\tNine\n")
    write(mp3, "a.fna\t7\t500\tA\nb.fna\t9\t600\tB\nc.fna\t7\t500\tA\n")
    files = {}
    mod.main(["--map_fn", mp, "--output_fn", out,
              "--add_genome", "g4.fna", "300", "Gamma three"])
    files["add"] = read(out)
    mod.main(["--map_fn", out, "--output_fn", out, "--del_genome", "g2.fna"])
    files["del"] = read(out)
    mod.main(["--map_fn", out, "--output_fn", out,
              "--add_genome", "g1.fna", "999", "Dup"])
    files["dup"] = read(out)
    mod.main(["--map_fn", out, "--output_fn", merged, "--merge_map", m2])
    files["merge"] = read(merged)
    mod.main(["--map_fn", mp3, "--sort_id"])
    files["sort"] = read(mp3)
    return files


def test_preprocess_add_del_merge_sort_match(tmp_path, capsys):
    got, want = ({}, {})
    errs = {}
    for who, out in (("port", got), ("jax", want)):
        d = tmp_path / who
        d.mkdir()
        out.update(_preprocess_steps(PP[who], str(d)))
        errs[who] = capsys.readouterr().err
    assert got == want
    rows = [ln.split("\t") for ln in got["add"].splitlines()]
    assert rows[-1] == ["g4.fna", "3", "300", "Gamma three"]
    assert [r[1] for r in rows] == ["1", "2", "2", "3"]
    assert [ln.split("\t")[1] for ln in got["sort"].splitlines()] == ["1", "2", "1"]
    assert errs["port"] == errs["jax"] == "Genome already in map file.\n"


# synthetic taxonomy: 1 <- 10(genus) <- 20(species) <- 30(strain)
#                     1 <- 40(family) <- 50(species)  (no genus level)
NODES = "".join(f"{t}\t|\t{p}\t|\t{r}\t|\n" for t, p, r in (
    ("1", "1", "no rank"), ("10", "1", "genus"), ("20", "10", "species"),
    ("30", "20", "strain"), ("40", "1", "family"), ("50", "40", "species")))
NAMES = "".join(f"{t}\t|\t{n}\t|\t\t|\t{c}\t|\n" for t, n, c in (
    ("10", "Genus ten", "scientific name"), ("10", "Ten", "synonym"),
    ("40", "Family forty", "scientific name")))


def test_preprocess_genus_rollup_matches(tmp_path):
    """--convert_to_genus on a local nodes.dmp/names.dmp (present, so the
    taxonomy download is skipped), then --clean."""
    outs = {}
    for who in PP:
        d = tmp_path / who
        d.mkdir()
        write(d / "nodes.dmp", NODES)
        write(d / "names.dmp", NAMES)
        write(d / "map.out", "x.fna\t1\t30\tStrain thirty\ny.fna\t2\t50\tSpecies fifty\n")
        PP[who].main(["--dir", str(d), "--map_fn", str(d / "map.out"),
                      "--output_fn", str(d / "rolled.out"), "--convert_to_genus"])
        outs[who] = read(d / "rolled.out")
        assert PP[who].read_nodes(str(d)) == PP["jax"].read_nodes(str(d))
        assert PP[who].read_names(str(d)) == {"10": "Genus ten", "40": "Family forty"}
        PP[who].main(["--dir", str(d), "--clean"])
        assert not (d / "nodes.dmp").exists() and not (d / "names.dmp").exists()
    assert outs["port"] == outs["jax"] == (
        "x.fna\t1\t10\tGenus ten\ny.fna\t2\t40\tFamily forty\n")
    parents = {"10": "1", "20": "10", "30": "20", "40": "1", "50": "40"}
    ranks = {"10": "genus", "20": "species", "30": "strain", "40": "family",
             "50": "species"}
    gm = {"x.fna": ("30", "Strain thirty"), "y.fna": ("50", "Species fifty")}
    assert tpp.convert_to_genus(gm, parents, ranks) == jpp.convert_to_genus(
        gm, parents, ranks) == {"30": "10", "50": "40"}
    assert tpp.RANK_W == jpp.RANK_W and tpp.TAXDUMP_URL == jpp.TAXDUMP_URL


SUMMARY = "\n".join([
    "#  header",
    "# assembly_accession\tbioproject\t...",
    # acc, ..cat(4), taxid(5), species_taxid(6), name(7), ..level(11), ..ftp(19)
    "\t".join(["GCF_1", "x", "x", "x", "na", "101", "100", "Eco one", "x", "x",
               "x", "Complete Genome", "x", "x", "x", "x", "x", "x", "x",
               "ftp://host/path/GCF_1v1"]),
    "\t".join(["GCF_2", "x", "x", "x", "reference genome", "102", "100",
               "Eco two", "x", "x", "x", "Complete Genome", "x", "x", "x",
               "x", "x", "x", "x", "ftp://host/path/GCF_2v1"]),
    "\t".join(["GCF_3", "x", "x", "x", "na", "201", "200", "Sal one", "x", "x",
               "x", "Scaffold", "x", "x", "x", "x", "x", "x", "x",
               "ftp://host/path/GCF_3v1"]),
    "\t".join(["GCF_4", "x", "x", "x", "na", "202", "200", "Sal two", "x", "x",
               "x", "Complete Genome", "x", "x", "x", "x", "x", "x", "x",
               "ftp://host/path/GCF_4v1"]),
    "",
])


@pytest.mark.parametrize("complete_only", [True, False])
@pytest.mark.parametrize("dedup", [True, False])
def test_download_parse_and_map_match(tmp_path, complete_only, dedup):
    p = str(tmp_path / "assembly_summary.txt")
    write(p, SUMMARY)
    rows = {who: DL[who].parse_assembly_summary(p, complete_only, dedup) for who in DL}
    assert rows["port"] == rows["jax"]
    assert len(rows["port"]) == {(True, True): 2, (True, False): 3,
                                 (False, True): 2, (False, False): 4}[complete_only, dedup]
    maps = {}
    for who in DL:
        mp = str(tmp_path / f"{who}.out")
        DL[who].write_map(rows[who], mp)
        maps[who] = read(mp)
    assert maps["port"] == maps["jax"]
    assert [DL["port"].genome_filename(r) for r in rows["port"]] == [
        jdl.genome_filename(r) for r in rows["jax"]]
    assert (tdl.NCBI_BASE, tdl.DIVISIONS) == (jdl.NCBI_BASE, jdl.DIVISIONS)


@pytest.mark.parametrize("flags", [[], ["--no-dedup"], ["--all-levels"]])
def test_download_cli_no_fetch_matches(tmp_path, flags):
    p = str(tmp_path / "assembly_summary.txt")
    write(p, SUMMARY)
    maps = {}
    for who in DL:
        mp = str(tmp_path / f"{who}_genome_map.out")
        DL[who].main(["--summary", p, "--map", mp, "--out", str(tmp_path / who),
                      "--no-fetch", *flags])
        maps[who] = read(mp)
        assert os.listdir(tmp_path / who) == []
    assert maps["port"] == maps["jax"]
    assert len(maps["port"].splitlines()) == {(): 2, ("--no-dedup",): 3,
                                              ("--all-levels",): 2}[tuple(flags)]


def test_version_matches():
    assert cammiq_tpu_torch.__version__ == cammiq_tpu.__version__
    assert cammiq_tpu_torch.__all__ == ["__version__"]
