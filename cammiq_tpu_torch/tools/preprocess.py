"""Map-file toolbox (port of the reference CAMMiQ-preprocess Python-2
script to Python 3): a copy of ``cammiq_tpu/tools/preprocess.py``
(``python -m cammiq_tpu_torch.tools.preprocess``).

Operations on genome map files (filename \t gid \t taxid \t name):
  --add_genome FASTA TAXID NAME   add a row (no fasta validation)
  --del_genome FASTA              remove a row
  --merge_map FILE2               merge another map into --map_fn
  --sort_id                       renumber ids 1..n grouped by taxid
  --convert_to_genus              walk the NCBI taxdump (nodes.dmp) parents
                                  with the reference's rank-weight table
                                  until the genus/higher level, re-id
                                  genomes (reference:
                                  CAMMiQ-preprocess:156-234)
"""

from __future__ import annotations

import argparse
import os
import sys
import tarfile
import urllib.request
from typing import Dict, List, Optional, Tuple

TAXDUMP_URL = "https://ftp.ncbi.nlm.nih.gov/pub/taxonomy/taxdump.tar.gz"

# rank weights (reference: CAMMiQ-preprocess main): walk up while the
# parent's rank weight is < 0 (below genus); stop at weight >= 0
RANK_W = {
    'superkingdom': 1, 'tribe': 1, 'subgenus': -1, 'family': 1,
    'species subgroup': -1, 'serotype': -1, 'strain': -1, 'species group': -1,
    'pathogroup': -1, 'superclass': 1, 'subspecies': -1, 'species': -1,
    'cohort': 0, 'no rank': -1, 'superorder': 1, 'infraorder': 1, 'clade': 0,
    'isolate': 0, 'subclass': 1, 'subsection': -1, 'series': -1, 'kingdom': 1,
    'subtribe': 1, 'forma specialis': -1, 'subphylum': 1, 'subkingdom': 1,
    'forma': -1, 'subvariety': -1, 'varietas': -1, 'subcohort': 0, 'biotype': 0,
    'serogroup': -1, 'superphylum': 1, 'subfamily': 1, 'class': 1, 'genotype': 0,
    'infraclass': 1, 'superfamily': 1, 'morph': 0, 'parvorder': 1, 'phylum': 1,
    'suborder': 1, 'section': -1, 'genus': 0, 'order': 1,
}


def read_map(path: str) -> Dict[str, Tuple[str, str]]:
    out: Dict[str, Tuple[str, str]] = {}
    with open(path) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if len(t) >= 4:
                out[t[0]] = (t[2], t[3])
    return out


def output_map(genome_map: Dict[str, Tuple[str, str]], path: str,
               gid_map: Optional[Dict[str, str]] = None,
               names: Optional[Dict[str, str]] = None) -> None:
    taxid2gid: Dict[str, int] = {}
    i = 1
    with open(path, "w") as f:
        for fn, (taxid, name) in genome_map.items():
            if gid_map is not None:
                new_taxid = gid_map.get(taxid, taxid)
                if names is not None and new_taxid in names:
                    taxid, name = new_taxid, names[new_taxid]
                elif new_taxid != taxid:
                    print(f"UNCONVERTED FILE {fn} WITH TAXONOMIC ID {taxid} "
                          f"AND NAME {name}.", file=sys.stderr)
            if taxid not in taxid2gid:
                taxid2gid[taxid] = i
                i += 1
            f.write(f"{fn}\t{taxid2gid[taxid]}\t{taxid}\t{name}\n")


def download_taxonomy(tdir: str) -> None:
    os.makedirs(tdir, exist_ok=True)
    tgz = os.path.join(tdir, "taxdump.tar.gz")
    if not (os.path.exists(os.path.join(tdir, "nodes.dmp"))
            and os.path.exists(os.path.join(tdir, "names.dmp"))):
        urllib.request.urlretrieve(TAXDUMP_URL, tgz)
        with tarfile.open(tgz) as t:
            t.extract("nodes.dmp", tdir)
            t.extract("names.dmp", tdir)


def read_nodes(tdir: str) -> Tuple[Dict[str, str], Dict[str, str]]:
    parents: Dict[str, str] = {}
    ranks: Dict[str, str] = {}
    with open(os.path.join(tdir, "nodes.dmp")) as f:
        for line in f:
            t = [x.strip() for x in line.split("|")]
            parents[t[0]] = t[1]
            ranks[t[0]] = t[2]
    return parents, ranks


def read_names(tdir: str) -> Dict[str, str]:
    names: Dict[str, str] = {}
    with open(os.path.join(tdir, "names.dmp")) as f:
        for line in f:
            t = [x.strip() for x in line.split("|")]
            if len(t) > 3 and t[3] == "scientific name":
                names[t[0]] = t[1]
    return names


def convert_to_genus(genome_map: Dict[str, Tuple[str, str]],
                     parents: Dict[str, str],
                     ranks: Dict[str, str]) -> Dict[str, str]:
    """taxid -> genus-level (or first weight>=0 ancestor) taxid."""
    gid_map: Dict[str, str] = {}
    for fn, (taxid, _name) in genome_map.items():
        t = taxid
        while True:
            if t not in parents or parents[t] == "1":
                break
            t = parents[t]
            if RANK_W.get(ranks.get(t, "no rank"), -1) >= 0:
                break
        gid_map[taxid] = t
    return gid_map


def main(argv=None):
    ap = argparse.ArgumentParser(description="CAMMiQ map-file toolbox")
    ap.add_argument("--dir", default="./")
    ap.add_argument("--map_fn", default="")
    ap.add_argument("--output_fn", default="")
    ap.add_argument("--add_genome", nargs=3, metavar=("FASTA", "TAXID", "NAME"))
    ap.add_argument("--del_genome", metavar="FASTA")
    ap.add_argument("--merge_map", metavar="FILE2")
    ap.add_argument("--convert_to_genus", action="store_true")
    ap.add_argument("--sort_id", action="store_true")
    ap.add_argument("--clean", action="store_true")
    a = ap.parse_args(argv)

    if a.clean:
        for fn in ("nodes.dmp", "names.dmp", "taxdump.tar.gz"):
            p = os.path.join(a.dir, fn)
            if os.path.exists(p):
                os.remove(p)
        return
    if not a.map_fn:
        sys.exit("Genome map file is required.")
    out = a.output_fn or a.map_fn
    gm = read_map(a.map_fn)

    if a.convert_to_genus:
        download_taxonomy(a.dir)
        parents, ranks = read_nodes(a.dir)
        names = read_names(a.dir)
        gid_map = convert_to_genus(gm, parents, ranks)
        output_map(gm, out, gid_map=gid_map, names=names)
    elif a.add_genome:
        fn, taxid, name = a.add_genome
        if fn in gm:
            print("Genome already in map file.", file=sys.stderr)
        else:
            gm[fn] = (taxid, name)
        output_map(gm, out)
    elif a.del_genome:
        gm.pop(a.del_genome, None)
        output_map(gm, out)
    elif a.merge_map:
        gm2 = read_map(a.merge_map)
        gm2.update(gm)
        output_map(gm2, out)
    elif a.sort_id:
        output_map(gm, out)
    else:
        sys.exit("Please specify an operation.")


if __name__ == "__main__":
    main()
