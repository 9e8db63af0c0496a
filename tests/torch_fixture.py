"""Hand-made indexes, corpora and reads for the port's tests, built with
the port's own code: nothing of the JAX package is imported, so the
card-only tests use them on a host without it."""

from __future__ import annotations

import numpy as np

from cammiq_tpu_torch.config import BuildConfig
from cammiq_tpu_torch.index.table import build_flat_index_from_entries
from cammiq_tpu_torch.io.fasta import corpus_from_sequences
from cammiq_tpu_torch.io.fastq import ReadSet, reads_from_arrays
from cammiq_tpu_torch.query.merged import build_merged_index


ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8)


def pair_genomes(seed, ng=5, glen=400, seg=90):
    """ng random genomes (int base codes) with one segment planted in
    exactly two genomes for each pair (g, g + 1 mod ng), so the doubly
    index has content.  Returns (genomes, [(genome, start)] of every
    planted copy)."""
    rng = np.random.default_rng(seed)
    gs = [rng.integers(0, 4, glen) for _ in range(ng)]
    planted = []
    for g in range(ng):
        s = rng.integers(0, 4, seg)
        for h in (g, (g + 1) % ng):
            at = int(rng.integers(0, glen - seg))
            gs[h][at:at + seg] = s
            planted.append((h, at))
    return gs, planted


def pair_reads(gs, planted, seed, n=240, Lp=64, seg=120, minus1=0.01):
    """A ReadSet of n reads of both strands, 40 to Lp bases, with 2%
    substitutions, half from planted segments (of ``pair_genomes``, ``seg``
    bases long); ``minus1`` of the codes within a read -1 (an N)."""
    rng = np.random.default_rng(seed)
    codes = np.zeros((n, Lp), np.int8)
    lengths = rng.integers(40, Lp + 1, n).astype(np.int32)
    for b in range(n):
        if b % 2:
            g, at = planted[int(rng.integers(len(planted)))]
            p = at + int(rng.integers(0, seg - Lp + 1))
        else:
            g = int(rng.integers(len(gs)))
            p = int(rng.integers(0, len(gs[g]) - Lp))
        x = gs[g][p:p + Lp].copy()
        if rng.random() < 0.5:
            x = 3 - x[::-1]
        err = rng.random(Lp) < 0.02
        x[err] = rng.integers(0, 4, int(err.sum()))
        codes[b, :lengths[b]] = x[:lengths[b]]
    codes[(rng.random(codes.shape) < minus1) & (np.arange(Lp) < lengths[:, None])] = -1
    return ReadSet(codes=codes, lengths=lengths, total_len=int(lengths.sum()),
                   name="pairs")


def by_entry_key(ix, values):
    """{(key words, length): value} over a FlatIndex's entries: tables that
    hold the same entries in another order (an import of the reference's
    format orders them by its trie walk) compare by key."""
    return {(tuple(int(w) for w in ix.key_words[e]), int(ix.length[e])): int(values[e])
            for e in range(ix.num_entries)}


def pair_corpus(seed, **kw):
    gs, _ = pair_genomes(seed, **kw)
    return corpus_from_sequences([[ALPHA[x].tobytes()] for x in gs])


def rc(codes):
    return [3 - c for c in reversed(codes)]


def _pack(codes, kw):
    w = [0] * kw
    for i, c in enumerate(codes):
        w[i // 16] |= (c & 3) << (2 * (i % 16))
    return w


def flat_table(keys, is_doubly, h, kw, load_factor=0.5):
    n = len(keys)
    rid1 = np.arange(1, n + 1, dtype=np.int64)
    rid2 = np.arange(2, n + 2, dtype=np.int64) if is_doubly else np.zeros(n, np.int64)
    uc = np.ones(n, np.int64)
    return build_flat_index_from_entries(
        np.asarray([_pack(k, kw) for k in keys], np.uint32),
        np.asarray([len(k) for k in keys], np.int64),
        rid1, uc, rid2, uc, h, is_doubly, load_factor)


def gather_tables(seed, h, n_u=400, n_d=60, load_factor=0.5):
    """(unique FlatIndex, doubly FlatIndex, keys) of random keys h to h + 13
    bases long, a dozen of the unique ones sharing one h-prefix (a bucket
    of several entries).  A load factor above 1 packs the hash table
    tight, so probes walk more than one slot."""
    rng = np.random.default_rng(seed)
    kw = max(2, (h + 13 + 15) // 16)

    def keys(n):
        return [list(rng.integers(0, 4, int(rng.integers(h, h + 14))))
                for _ in range(n)]

    P = list(rng.integers(0, 4, h))
    u = [P + list(t) for t in rng.permutation(64)[:12, None] // [16, 4, 1] % 4]
    u += keys(n_u)
    d = keys(n_d)
    return (flat_table(u, False, h, kw, load_factor),
            flat_table(d, True, h, kw, load_factor), u + d)


def end_run_table(seed, h, n=300):
    """(unique FlatIndex, doubly FlatIndex, unique keys): the unique table
    has 2^10 rows, its last run ends at row T - 1 and row 0 is occupied,
    so a walk from its last rows wraps to the top of the table."""
    from cammiq_tpu_torch.index.table import _prefix_lo_hi, hash_prefix

    rng = np.random.default_rng(seed)
    kw = max(2, (h + 13 + 15) // 16)
    T = 1024                        # n keys at load factor 0.5
    wanted = {T - 2: 1, T - 1: 1, 0: 1}
    keys = []
    while len(keys) < n:
        k = list(rng.integers(0, 4, int(rng.integers(h, h + 14))))
        lo, hi = _prefix_lo_hi(np.asarray([_pack(k, kw)], np.uint32), h)
        s = int(hash_prefix(lo, hi)[0]) & (T - 1)
        if wanted.get(s):
            wanted[s] -= 1
            keys.append(k)
        elif 0 < s < T - 64 and len(keys) < n - sum(wanted.values()):
            keys.append(k)
    iu = flat_table(keys, False, h, kw)
    assert len(iu.table_start) == T and iu.table_start[[0, T - 2, T - 1]].min() >= 0
    d = [list(rng.integers(0, 4, int(rng.integers(h, h + 14)))) for _ in range(40)]
    return iu, flat_table(d, True, h, kw), keys


def planted_reads(seed, keys, B, Lp, minus1=0.03):
    """int8 codes [B, Lp] and int32 lengths: random reads (a tenth empty or
    shorter than 16) with one key each planted, a third of them reverse
    complemented; ``minus1`` of all codes -1, padding included."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, Lp)).astype(np.int8)
    lengths = rng.integers(Lp // 2, Lp + 1, B)
    lengths[rng.random(B) < 0.1] = rng.integers(0, 16)
    for b in range(B):
        k = keys[int(rng.integers(len(keys)))]
        if b % 3 == 0:
            k = rc(k)
        if len(k) <= lengths[b]:
            off = int(rng.integers(0, lengths[b] - len(k) + 1))
            codes[b, off:off + len(k)] = k
    codes[rng.random(codes.shape) < minus1] = -1
    return codes, lengths.astype(np.int32)


def large_bucket_index(seed=77):
    """(MergedIndex, int8 reads [48, 100], int32 lengths [48]): twelve
    unique keys share one 26-base prefix, so one bucket holds more than 8
    entries; every read carries one of them (a quarter reverse-complemented)."""
    rng = np.random.default_rng(seed)
    h, kw = 26, 4
    P = list(rng.integers(0, 4, h))
    big = [P + list(t) for t in
           rng.permutation(64)[:12, None] // [16, 4, 1] % 4]
    u_keys = big + [list(rng.integers(0, 4, int(rng.integers(h, 34))))
                    for _ in range(40)]
    d_keys = [list(rng.integers(0, 4, 30)) for _ in range(4)]
    m = build_merged_index(flat_table(u_keys, False, h, kw),
                           flat_table(d_keys, True, h, kw))
    reads = rng.integers(0, 4, size=(48, 100)).astype(np.int8)
    for b in range(48):
        s = big[b % 12] if b % 4 else rc(big[b % 12])
        off = int(rng.integers(0, 100 - len(s)))
        reads[b, off:off + len(s)] = s
    lengths = rng.integers(60, 101, 48).astype(np.int32)
    return m, reads, lengths


def dist_fixture(seed: int = 5):
    """``tests/dist_fixture.py:make_dist_fixture`` with the port's build on
    the CPU (the same index): a 4-genome --both index and 256 reads.
    Returns (BuildArtifacts, ReadSet, number of genome slots)."""
    from cammiq_tpu_torch.index.builder import build_index

    rng = np.random.default_rng(seed)
    length = 400
    shared = rng.integers(0, 4, size=150)
    genomes = []
    for g in range(4):
        own = rng.integers(0, 4, size=length)
        ins = int(rng.integers(0, length - 150))
        seq = np.concatenate([own[:ins], shared, own[ins:]])
        genomes.append([ALPHA[seq].tobytes()])
    corpus = corpus_from_sequences(genomes)
    cfg = BuildConfig(k=12, L=60, Lmax=30, h=12, mode="both")
    art = build_index(corpus, cfg, device="cpu")
    reads = []
    for _ in range(256):
        g = int(rng.integers(0, 4))
        c = genomes[g][0]
        p = int(rng.integers(0, len(c) - 60))
        r = c[p : p + 60]
        if rng.random() < 0.5:
            comp = {65: 84, 67: 71, 71: 67, 84: 65}
            r = bytes(comp[b] for b in reversed(r))
        reads.append(r)
    rs = reads_from_arrays(reads, max_len=64)
    G = int(corpus.ref_id.max()) + 1
    return art, rs, G


# ---- match slots for the case analysis (kernels/case_count.py)

CASE_BRANCHES = ("undet", "u_only", "ud_in", "ud_out", "pair", "isect0",
                 "isect1", "isect2", "u_many")
SLOT_BIG = 2**31 - 1


def _branch_payloads(rng, branch, G):
    """The (rid1, rid2) payloads of one read's distinct matches for one
    branch of the case table (rid2 = 0: a single)."""
    a, b, c, d, e = (int(x) for x in rng.choice(np.arange(1, G), 5, replace=False))
    pair = lambda x, y: (x, y) if rng.random() < 0.5 else (y, x)  # noqa: E731
    return {
        "undet": [],
        "u_only": [(a, 0)],
        "ud_in": [(a, 0), pair(a, b), pair(c, a)],
        "ud_out": [(a, 0), pair(a, b), pair(c, d)],
        "pair": [pair(a, b)] * int(rng.integers(1, 3)),
        "isect0": [pair(a, b), pair(c, d)],
        "isect1": [pair(a, b), pair(a, c), pair(e, a)],
        # (x, x) is the smaller pair: a1 = b1 = x, both in every pair
        "isect2": [(min(a, b),) * 2, pair(a, b)],
        "u_many": [(a, 0), (b, 0)] + [pair(a, b)] * int(rng.integers(0, 2)),
    }[branch]


def case_rows(seed, B, S, G, branch="mixed", id_space=200_000, copies=3):
    """int32 slots, rid1, rid2 [B, S] and lengths [B] whose reads take
    ``branch`` of the case table (``CASE_BRANCHES``), or a random branch
    each ("mixed"), "dups" (mixed, every entry in 2 to 4 columns),
    "all_big" (every slot empty) or "padding" (mixed, a third of the reads
    of length 0).  Each payload maps to 1 to ``copies`` entry ids, an id
    may repeat in a read (equal ids carry equal payloads, as in the
    engines' slots), ids lie in [0, id_space) and the empty columns (BIG)
    carry garbage rids.  Rows wider than 64 also get many entries of one
    payload, and the first row of a wide batch is full."""
    rng = np.random.default_rng(seed)
    slots = np.full((B, S), SLOT_BIG, np.int64)
    rid1 = rng.integers(-5, 2 * G, (B, S))
    rid2 = rng.integers(-5, 2 * G, (B, S))
    lengths = rng.integers(40, 101, B)
    by_payload = {}
    free = rng.permutation(id_space)
    nfree = 0
    for r in range(B):
        kind = branch
        if branch in ("mixed", "dups", "padding"):
            kind = CASE_BRANCHES[int(rng.integers(len(CASE_BRANCHES)))]
        if branch == "all_big":
            kind = "undet"
        cols = []
        for p in _branch_payloads(rng, kind, G):
            ids = by_payload.setdefault(p, [])
            want = int(rng.integers(1, copies + 1))
            if S > 64 and rng.random() < 0.3:
                want = int(rng.integers(1, S // 4 + 1))
            for _ in range(want):
                if not ids or rng.random() < 0.6:
                    ids.append(int(free[nfree]))
                    nfree += 1
                reps = int(rng.integers(2, 5)) if branch == "dups" else 1
                cols += [(ids[int(rng.integers(len(ids)))], p)] * reps
        if S > 64 and r == 0 and kind != "undet":
            cols = (cols * (S // max(len(cols), 1) + 1))[:S]
        cols = cols[:S]
        at = rng.choice(S, len(cols), replace=False)
        for j, (i, (x, y)) in zip(at, cols):
            slots[r, j], rid1[r, j], rid2[r, j] = i, x, y
    if branch == "padding":
        lengths[rng.random(B) < 1 / 3] = 0
    return (slots.astype(np.int32), rid1.astype(np.int32), rid2.astype(np.int32),
            lengths.astype(np.int32))


# ---- strain families (tests/test_realistic.py's generator, cut in size:
# a tenth of its families, a fifth of its genome length, its strain-private
# segments scaled with it)

STRAIN_RATES = (0.05, 0.01, 0.002, 0.001)   # per strain: 95% .. 99.9% ANI
FAMILIES = 3
UNRELATED = 4
GLEN = 4000
BACKBONE = 600         # shared by every third genome
PRIVATE_SEGS = 3
PRIVATE_LEN = 60
STRAIN_BUILD = dict(k=21, L=100, Lmax=40, h=21, mode="both")


def mutate(rng, seq, rate):
    """Substitutions at `rate` plus a few strain-private segments
    (``tests/test_realistic.py:_mutate``): real strains differ by gene
    content as well as SNPs, and the private islands are what makes very
    close strains identifiable at all."""
    v = seq.copy()
    m = int(round(rate * v.shape[0]))
    if m:
        pos = rng.choice(v.shape[0], size=m, replace=False)
        v[pos] = (v[pos] + rng.integers(1, 4, size=m)) % 4
    for _ in range(PRIVATE_SEGS):
        at = int(rng.integers(0, v.shape[0] - PRIVATE_LEN))
        v[at : at + PRIVATE_LEN] = rng.integers(0, 4, size=PRIVATE_LEN)
    return v


def strain_genomes():
    """int base codes of FAMILIES x len(STRAIN_RATES) strains (each a
    mutation of its family's ancestor) and UNRELATED random genomes, GLEN
    bases each, with a BACKBONE shared by every third genome (content in
    more than two genomes enters neither table but shapes the
    conflicts)."""
    rng = np.random.default_rng(11)
    bb = rng.integers(0, 4, size=BACKBONE)
    gs = []
    for _ in range(FAMILIES):
        anc = rng.integers(0, 4, size=GLEN)
        gs += [mutate(rng, anc, rate) for rate in STRAIN_RATES]
    gs += [rng.integers(0, 4, size=GLEN) for _ in range(UNRELATED)]
    for gi in range(0, len(gs), 3):
        at = int(rng.integers(0, GLEN - BACKBONE))
        gs[gi][at : at + BACKBONE] = bb
    return gs


def strain_reads(gs, seed, n):
    """A ReadSet of n 100-base reads of both strands sampled uniformly
    from the genomes with 1% substitutions (the bench sampler,
    ``tools/benchdata.py:sample_read_batch``)."""
    from cammiq_tpu_torch.tools.benchdata import sample_read_batch

    rng = np.random.default_rng(seed)
    codes, lengths = sample_read_batch(rng, [[ALPHA[g].tobytes()] for g in gs], n)
    return ReadSet(codes=codes, lengths=lengths, total_len=int(lengths.sum()),
                   name="strains")


def strain_index():
    """(BuildArtifacts, genomes, number of genome slots) of
    ``strain_genomes``, built by the port's numpy host engine with
    ``tests/test_realistic.py``'s k, L, Lmax and h."""
    from cammiq_tpu_torch.index.builder import build_index

    gs = strain_genomes()
    corpus = corpus_from_sequences([[ALPHA[g].tobytes()] for g in gs])
    art = build_index(corpus, BuildConfig(**STRAIN_BUILD), engine="numpy")
    return art, gs, len(gs) + 1


# ---- match lists for the sort join's assembly (kernels/match_assemble.py)

# name -> match_list arguments: B, O, kp, n valid matches, entries a read
# draws from, and the case's twist
MATCH_CASES = {
    # several matches a read drawn from 3 entries (often one gid twice, as
    # an entry and its reverse complement), across offsets and colors
    "dups": dict(B=64, O=20, kp=600, n=500, pool=3),
    # reads with tens of distinct gids: past every tested maxm but 64
    "overflow": dict(B=48, O=40, kp=1200, n=1000, pool=60),
    # more matches found than the list holds: counts[0] > KP
    "over_kp": dict(B=64, O=20, kp=300, n=300, pool=4, counts0=420),
    "empty": dict(B=32, O=10, kp=200, n=0, pool=4),
    # the slots past the valid prefix hold rows and entries out of range
    "garbage": dict(B=64, O=20, kp=600, n=250, pool=4, garbage=True),
    # B not a multiple of any block's reads, a few reads holding most matches
    "skewed": dict(B=100, O=30, kp=900, n=700, pool=12, skew=True),
    # every match in one read
    "one_read": dict(B=16, O=500, kp=2000, n=2000, pool=300, one_read=True),
    # reads holding exactly 4g and 4g + 1 matches for g = 8, 16 and 32
    # lanes: the kernel's bucket full, and one match past it
    "bucket_edge": dict(B=16, O=200, kp=1000, n=904, pool=48,
                        sizes=(32, 33, 64, 65, 128, 129, 0, 1)),
}


def match_prec(rng, E):
    """(int32 prec [E, 3], eu): about two entries a gid, each gid's rids
    fixed (equal ids carry equal payloads), a third of the gids pairs."""
    ngid = max(E // 2, 1)
    gid = rng.integers(0, ngid, E)
    r1 = rng.integers(1, 60, ngid)
    r2 = np.where(rng.random(ngid) < 0.3, rng.integers(1, 60, ngid), 0)
    return (np.stack([gid, r1[gid], r2[gid]], 1).astype(np.int32),
            int(ngid * 0.7))


def match_list(seed, B, O, kp, n, pool, E=1024, counts0=None, garbage=False,
               skew=False, one_read=False, sizes=None):
    """A match list as ``cuckoo_verify`` leaves it: (int32 mrow [kp] = read
    * O + offset, int32 me [kp], int32 counts [2], int32 prec [E, 3], eu),
    the first min(counts[0], kp) valid, in no order; each read draws its
    entries from ``pool`` consecutive ones.  With ``sizes`` read r holds
    exactly ``sizes[r % len(sizes)]`` matches (n must be their sum).  The
    slots past the valid prefix hold 0, or with ``garbage`` rows and
    entries out of range."""
    rng = np.random.default_rng(seed)
    prec, eu = match_prec(rng, E)
    if sizes is not None:
        reads = rng.permutation(np.repeat(np.arange(B), np.resize(sizes, B)))
        assert len(reads) == n, (len(reads), n)
    elif one_read:
        reads = np.full(n, int(rng.integers(0, B)))
    elif skew:
        reads = (rng.random(n) ** 4 * B).astype(np.int64)
    else:
        reads = rng.integers(0, B, n)
    first = rng.integers(0, E, B)
    mrow = np.zeros(kp, np.int32)
    me = np.zeros(kp, np.int32)
    mrow[:n] = reads * O + rng.integers(0, O, n)
    me[:n] = (first[reads] + rng.integers(0, pool, n)) % E
    if garbage:
        bad = kp - n
        mrow[n:] = np.where(rng.random(bad) < 0.5, rng.integers(-2**31, 0, bad),
                            rng.integers(B * O, 2**31 - 1, bad))
        me[n:] = np.where(rng.random(bad) < 0.5, rng.integers(-2**31, 0, bad),
                          rng.integers(E, 2**31 - 1, bad))
    found = n if counts0 is None else counts0
    counts = np.array([found, max(found - kp, 0)], np.int32)
    return mrow, me, counts, prec, eu


def assemble_oracle(mrow, me, counts, prec, O, B, maxm, eu):
    """numpy twin of the assembly: (slots, rid1, rid2, in_u, overflow)."""
    big = SLOT_BIG
    n = min(int(counts[0]), len(mrow))
    per = {}
    for i in range(n):
        per.setdefault(int(mrow[i]) // O, {})[int(prec[me[i], 0])] = prec[me[i]]
    slots = np.full((B, maxm), big, np.int32)
    rid1 = np.zeros((B, maxm), np.int32)
    rid2 = np.zeros((B, maxm), np.int32)
    over = 0
    for r, by_gid in per.items():
        gids = sorted(by_gid)
        over += max(len(gids) - maxm, 0)
        for k, g in enumerate(gids[:maxm]):
            slots[r, k], rid1[r, k], rid2[r, k] = by_gid[g]
    return slots, rid1, rid2, (slots < big) & (slots < eu), over


# ---- quantification problems (models/quant.py)

def fake_index(rid1, rid2, uc1, uc2, length, is_doubly):
    """``tests/test_quant_exact.py:fake_index`` with the port's FlatIndex:
    entries only, an empty hash table (build_problem reads no key)."""
    from cammiq_tpu_torch.index.table import FlatIndex

    E = len(rid1)
    kw = 4
    return FlatIndex(
        h=26, kw=kw,
        key_words=np.zeros((E, kw), np.uint32),
        length=np.asarray(length, np.int32),
        rid1=np.asarray(rid1, np.int32), rid2=np.asarray(rid2, np.int32),
        ucount1=np.asarray(uc1, np.int32), ucount2=np.asarray(uc2, np.int32),
        table_lo=np.zeros(8, np.uint32), table_hi=np.zeros(8, np.uint32),
        table_start=np.full(8, -1, np.int32), table_count=np.zeros(8, np.int32),
        max_probes=1, max_bucket=1, is_doubly=is_doubly,
    )


def make_instance(rng, n_sp=6, per_genome_u=3, n_d=9, easy_thres=10**9,
                  rl=100, erate=0.0, total_slack=(0.95, 1.6),
                  ilp_alpha=0.0):
    """``tests/test_quant_exact.py:make_instance`` without the JAX package
    (the same draws from ``rng``, the port's FlatIndex and FineParams): a
    random instance in which every genome survives the pre-filter."""
    from cammiq_tpu_torch.config import FineParams

    n = n_sp + 1
    rid1_u = np.repeat(np.arange(1, n), per_genome_u)
    uc1_u = rng.integers(1, 4, size=len(rid1_u))
    len_u = rng.integers(28, 48, size=len(rid1_u))
    index_u = fake_index(rid1_u, np.zeros_like(rid1_u), uc1_u,
                         np.zeros_like(uc1_u), len_u, False)
    g1 = rng.integers(1, n, size=n_d)
    off = rng.integers(1, n_sp, size=n_d)
    g2 = (g1 - 1 + off) % n_sp + 1
    lo, hi = np.minimum(g1, g2), np.maximum(g1, g2)
    uc1_d = rng.integers(1, 4, size=n_d)
    uc2_d = rng.integers(1, 4, size=n_d)
    len_d = rng.integers(28, 48, size=n_d)
    index_d = fake_index(lo, hi, uc1_d, uc2_d, len_d, True)

    present = rng.random(n) < 0.55
    present[0] = False
    cov = np.where(present, rng.uniform(0.3, 4.0, size=n), 0.0)

    def wcov(uc, depth):
        return uc * (rl - depth) / rl * (1.0 - erate) ** depth

    w_u = wcov(uc1_u.astype(float), len_u.astype(float))
    rc_u = np.maximum(
        np.round(w_u * cov[rid1_u]
                 + rng.normal(0, 0.08, size=len(rid1_u))
                 + (rng.random(len(rid1_u)) < 0.15) * rng.integers(0, 2, len(rid1_u))),
        0.0,
    )
    w1_d = wcov(uc1_d.astype(float), len_d.astype(float))
    w2_d = wcov(uc2_d.astype(float), len_d.astype(float))
    rc_d = np.maximum(
        np.round(w1_d * cov[lo] + w2_d * cov[hi]
                 + rng.normal(0, 0.08, size=n_d)),
        0.0,
    )

    nus = rng.integers(10, 60, size=n).astype(np.float64)
    nds = rng.integers(5, 30, size=n).astype(np.float64)
    sum_rc_u = np.zeros(n)
    np.add.at(sum_rc_u, rid1_u, rc_u)
    sum_rc_d = np.zeros(n)
    np.add.at(sum_rc_d, lo, rc_d)
    np.add.at(sum_rc_d, hi, rc_d)
    cnts_u = np.floor(sum_rc_u * rng.uniform(0.8, 0.95, size=n))
    cnts_d = np.floor(sum_rc_d * rng.uniform(0.7, 0.9, size=n))
    glength = rng.integers(50_000, 100_000, size=n).astype(np.int64)
    glength[0] = 0
    tot = float(np.dot(cov, glength) / rl)
    num_reads = int(np.ceil(max(tot, 1.0) * rng.uniform(*total_slack)))
    fine = FineParams(read_cnt_thres=1, easy_to_identify_thres=easy_thres,
                      ilp_epsilon=0.01, ilp_alpha=ilp_alpha, max_cov=100.0)
    return dict(index_u=index_u, index_d=index_d, rcount_u=rc_u,
                rcount_d=rc_d, cnts_u=cnts_u, cnts_d=cnts_d, nus=nus,
                nds=nds, glength=glength, rl=rl, num_reads=num_reads,
                erate=erate, fine=fine)


# the instance kinds of tests/test_quant_exact.py and
# tests/test_quant_beyond_cap.py: make_instance keyword arguments
QUANT_UNCONSTRAINED = {}
QUANT_CONSTRAINED = dict(n_sp=5, easy_thres=30, total_slack=(1.15, 1.6),
                         ilp_alpha=1e-4)
QUANT_BEYOND_CAP = dict(n_sp=11, per_genome_u=3, n_d=12)


def quant_problem(seed, **kw):
    """``models.quant.build_problem`` of ``make_instance`` (seed, kw)."""
    from cammiq_tpu_torch.models.quant import build_problem

    inst = make_instance(np.random.default_rng(seed), **kw)
    return build_problem(
        inst["index_u"], inst["index_d"], inst["rcount_u"], inst["rcount_d"],
        inst["cnts_u"], inst["cnts_d"], inst["nus"], inst["nds"],
        inst["glength"], inst["rl"], inst["num_reads"], inst["erate"],
        inst["fine"])
