"""TPC-H's eight tables, drawn from a seed on the device.

TPC Benchmark H Standard Specification, revision 3.0.1, section 4.2: at
scale factor SF, part 200,000 x SF rows, supplier 10,000 x SF, partsupp
four rows a part, customer 150,000 x SF, orders 1,500,000 x SF of 1 to 7
lineitems each, nation 25 and region 5. Every column of section 4.2.3 is
made with its stated domain or formula:

- o_orderkey sparse: the first 8 of every 32 key values;
- o_custkey never a multiple of 3, so a third of the customers order
  nothing;
- ps_suppkey = (ps_partkey + i (S/4 + (ps_partkey - 1) / S)) mod S + 1 for
  the part's i-th supplier, i in 0..3, and l_suppkey one of its part's four;
- p_retailprice = (90000 + (p_partkey / 10) mod 20001 + 100 (p_partkey mod
  1000)) / 100 and l_extendedprice = l_quantity x p_retailprice;
- l_shipdate, l_commitdate and l_receiptdate as offsets from o_orderdate,
  l_returnflag and l_linestatus from them against 1995-06-17, and
  o_orderstatus and o_totalprice from the order's lines;
- p_name five distinct words of the 92 colours, p_type of the 150 syllable
  combinations, p_container of the 40, the 25 nations and 5 regions;
- phone numbers whose country code is the nation key + 10;
- the "Customer ... Complaints" and "Customer ... Recommends" rows of
  s_comment, 5 x SF of each;
- every comment a substring of a text pool made from section 4.2.2.10's
  grammar, at its column's length range.

The departures (DECIMAL as DOUBLE, integers as BIGINT, lineitem's row count
fixed for every seed, the text pool's size) are the configuration's
`assumed` (`configs/tpch-sf10.json`).

Strings are int32 codes into a sorted dictionary built in bulk: each string
column is first a byte matrix on the device, its rows sorted as big-endian
words by a stable sort a word, the distinct rows found by comparing
neighbours, and only the distinct values become Python strings, split out of
one decoded buffer.
"""

from __future__ import annotations

import datetime
import sys
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from port_bench.data.common import Draw
from port_bench.data.ssb import COLORS, NATIONS, REGIONS, _lines_multiset
from port_bench.tables import Table

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                "TAKE BACK RETURN"]
MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
TYPE_1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONT_1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONT_2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
EPOCH = datetime.date(1970, 1, 1)
START_DATE = (datetime.date(1992, 1, 1) - EPOCH).days
END_DATE = (datetime.date(1998, 12, 31) - EPOCH).days
CURRENT_DATE = (datetime.date(1995, 6, 17) - EPOCH).days

# Section 4.2.2.10's word lists, each word with the weight dbgen's
# dists.dss gives it
NOUNS = [("packages", 40), ("requests", 40), ("accounts", 40),
         ("deposits", 40), ("foxes", 20), ("ideas", 20),
         ("theodolites", 20), ("pinto beans", 20), ("instructions", 20),
         ("dependencies", 10), ("excuses", 10), ("platelets", 10),
         ("asymptotes", 10), ("courts", 5), ("dolphins", 5)] + [
    (w, 1) for w in (
        "multipliers", "sauternes", "warthogs", "frets", "dinos",
        "attainments", "somas", "Tiresias'", "patterns", "forges", "braids",
        "hockey players", "frays", "warhorses", "dugouts", "notornis",
        "epitaphs", "pearls", "tithes", "waters", "orbits", "gifts",
        "sheaves", "depths", "sentiments", "decoys", "realms", "pains",
        "grouches", "escapades")]
VERBS = [("sleep", 20), ("wake", 20), ("are", 20), ("cajole", 20),
         ("haggle", 20), ("nag", 10), ("use", 10), ("boost", 10),
         ("affix", 5), ("detect", 5), ("integrate", 5)] + [
    (w, 1) for w in (
        "maintain", "nod", "was", "lose", "sublate", "solve", "thrash",
        "promise", "engage", "hinder", "print", "x-ray", "breach", "eat",
        "grow", "impress", "mold", "poach", "serve", "run", "dazzle",
        "snooze", "doze", "unwind", "kindle", "play", "hang", "believe",
        "doubt")]
ADJECTIVES = [("special", 20), ("pending", 20), ("unusual", 20),
              ("express", 20)] + [
    (w, 1) for w in (
        "furious", "sly", "careful", "blithe", "quick", "fluffy", "slow",
        "quiet", "ruthless", "thin", "close", "dogged", "daring", "brave",
        "stealthy", "permanent", "enticing", "idle", "busy")] + [
    ("regular", 50), ("final", 40), ("ironic", 40), ("even", 30),
    ("bold", 20), ("silent", 10)]
ADVERBS = [("sometimes", 1), ("always", 1), ("never", 1),
           ("furiously", 50), ("slyly", 50), ("carefully", 50),
           ("blithely", 40), ("quickly", 30), ("fluffily", 20)] + [
    (w, 1) for w in (
        "slowly", "quietly", "ruthlessly", "thinly", "closely", "doggedly",
        "daringly", "bravely", "stealthily", "permanently", "enticingly",
        "idly", "busily", "regularly", "finally", "ironically", "evenly",
        "boldly", "silently")]
PREPOSITIONS = [("about", 50), ("above", 50), ("according to", 50),
                ("across", 50), ("after", 50), ("against", 40),
                ("along", 40), ("alongside of", 30), ("among", 30),
                ("around", 20), ("at", 10)] + [
    (w, 1) for w in (
        "atop", "before", "behind", "beneath", "beside", "besides",
        "between", "beyond", "by", "despite", "during", "except", "for",
        "from", "in place of", "inside", "instead of", "into", "near", "of",
        "on", "outside", "over", "past", "since", "through", "throughout",
        "to", "toward", "under", "until", "up", "upon", "without", "with",
        "within")]
AUXILIARIES = [(w, 1) for w in (
    "do", "may", "might", "shall", "will", "would", "can", "could",
    "should", "ought to", "must", "will have to", "shall have to",
    "could have to", "should have to", "must have to", "need to", "try to")]
TERMINATORS = [(".", 50), (";", 1), (":", 1), ("?", 1), ("!", 1),
               ("--", 1)]
# word classes of the grammar: N V J D P X T, "the", and an adjective
# followed by a comma
N, V, J, D, P, X, T, THE, JC = range(9)
CLASSES = [NOUNS, VERBS, ADJECTIVES, ADVERBS, PREPOSITIONS, AUXILIARIES,
           TERMINATORS, [("the", 1)], [(w + ",", c) for w, c in ADJECTIVES]]
# phrases: noun, verb, prepositional; each form's classes and weight
NOUN_PHRASES = [([N], 10), ([J, N], 20), ([JC, J, N], 10), ([D, J, N], 50)]
VERB_PHRASES = [([V], 30), ([X, V], 1), ([V, D], 40), ([X, V, D], 1)]
NP, VP, PP, TERM = range(4)
SENTENCES = [([NP, VP, TERM], 3), ([NP, VP, PP, TERM], 3),
             ([NP, VP, NP, TERM], 3), ([NP, PP, VP, NP, TERM], 1),
             ([NP, PP, VP, PP, TERM], 1)]
ALNUM = (b"0123456789abcdefghijklmnopqrstuvwxyz"
         b"ABCDEFGHIJKLMNOPQRSTUVWXYZ,.")
WORD = 8    # bytes a sort word


def _weighted(d: Draw, weights: Sequence[int], n: int) -> torch.Tensor:
    """n draws of an index with the given weights."""
    cum = torch.tensor(np.cumsum(weights), dtype=torch.int64,
                       device=d.device)
    u = d.ints(0, int(cum[-1]), n)
    return torch.searchsorted(cum, u, right=True)


def _vocab(words: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """(uint8 buffer of the words one after another, start of each)."""
    raw = [w.encode() for w in words]
    starts = np.cumsum([0] + [len(w) for w in raw])
    return np.frombuffer(b"".join(raw), dtype=np.uint8), starts


def _sentences(d: Draw, n: int) -> np.ndarray:
    """The classes of the words of n sentences, one after another, with
    each sentence's forms drawn by their weights."""
    pad = -1
    table = np.full((4, 4, 6), pad, dtype=np.int64)
    for f, (cls, _) in enumerate(NOUN_PHRASES):
        table[NP, f, :len(cls)] = cls
        table[PP, f, :len(cls) + 2] = [P, THE] + cls
    for f, (cls, _) in enumerate(VERB_PHRASES):
        table[VP, f, :len(cls)] = cls
    table[TERM, :, 0] = T
    shapes = np.full((len(SENTENCES), 5), pad, dtype=np.int64)
    for s, (phrases, _) in enumerate(SENTENCES):
        shapes[s, :len(phrases)] = phrases
    form = _weighted(d, [w for _, w in SENTENCES], n).cpu().numpy()
    kinds = shapes[form]                                   # [n, 5]
    np_form = _weighted(d, [w for _, w in NOUN_PHRASES],
                        n * 5).cpu().numpy().reshape(n, 5)
    vp_form = _weighted(d, [w for _, w in VERB_PHRASES],
                        n * 5).cpu().numpy().reshape(n, 5)
    phrase_form = np.where(kinds == VP, vp_form, np_form)
    cls = table[np.maximum(kinds, 0), phrase_form]         # [n, 5, 6]
    cls[kinds < 0] = pad
    cls = cls.reshape(-1)
    return cls[cls >= 0]


def text_pool(d: Draw, size: int) -> torch.Tensor:
    """`size` bytes of text from the grammar of section 4.2.2.10: sentences
    of words separated by blanks, a terminator closing each, on the
    device."""
    words = [w for c in CLASSES for w, _ in c]
    buf, starts = _vocab(words)
    first = np.cumsum([0] + [len(c) for c in CLASSES])
    pieces, have = [], 0
    while have < size:
        cls = _sentences(d, max(size // 24, 1024))
        wid = np.empty(len(cls), dtype=np.int64)
        for c, words_c in enumerate(CLASSES):
            at = np.nonzero(cls == c)[0]
            wid[at] = first[c] + _weighted(
                d, [w for _, w in words_c], len(at)).cpu().numpy()
        wlen = starts[wid + 1] - starts[wid]
        # a blank before every word but a terminator
        blank = (cls != T).astype(np.int64)
        blank[0] = 0 if not pieces else 1
        out_start = np.cumsum(blank + wlen) - wlen        # the word's bytes
        total = int(out_start[-1] + wlen[-1])
        out = np.full(total, ord(" "), dtype=np.uint8)
        within = np.arange(int(wlen.sum())) - np.repeat(
            np.cumsum(wlen) - wlen, wlen)
        out[np.repeat(out_start, wlen) + within] = buf[
            np.repeat(starts[wid], wlen) + within]
        pieces.append(out)
        have += total
    pool = np.concatenate(pieces)[:size]
    return torch.as_tensor(pool, device=d.device)


def _texts(d: Draw, pool: torch.Tensor, n: int, lo: int, hi: int):
    """(uint8 [n, hi] matrix, lengths) of n comments: substrings of the
    pool at a uniform offset, of a uniform length in [lo, hi]."""
    lens = d.ints(lo, hi + 1, n)
    offs = d.ints(0, len(pool) - hi, n)
    cols = torch.arange(hi, device=d.device)
    mat = pool[offs[:, None] + cols[None, :]]
    mat[cols[None, :] >= lens[:, None]] = 0
    return mat, lens


def _vstrings(d: Draw, n: int, lo: int, hi: int):
    """(matrix, lengths) of n random strings of ALNUM's 64 symbols, of a
    uniform length in [lo, hi] (section 4.2.2.7)."""
    alnum = torch.tensor(list(ALNUM), dtype=torch.uint8, device=d.device)
    lens = d.ints(lo, hi + 1, n)
    mat = alnum[d.ints(0, len(ALNUM), n * hi).view(n, hi)]
    mat[torch.arange(hi, device=d.device)[None, :] >= lens[:, None]] = 0
    return mat, lens


def _digits(values: torch.Tensor, width: int) -> torch.Tensor:
    """uint8 [n, width]: the zero-padded decimal digits of each value."""
    pw = 10 ** torch.arange(width - 1, -1, -1, device=values.device)
    return ((values[:, None] // pw) % 10 + ord("0")).to(torch.uint8)


def _compose(n: int, parts, device):
    """(matrix, lengths) of n strings, each the concatenation of the parts:
    a bytes literal, or a (matrix, lengths) pair of n rows."""
    full = []
    for p in parts:
        if isinstance(p, bytes):
            m = torch.tensor(list(p), dtype=torch.uint8, device=device)
            full.append((m.expand(n, len(p)),
                         torch.full((n,), len(p), dtype=torch.int64,
                                    device=device)))
        else:
            full.append(p)
    width = sum(m.shape[1] for m, _ in full)
    out = torch.zeros((n, width), dtype=torch.uint8, device=device)
    cur = torch.zeros(n, dtype=torch.int64, device=device)
    rows = torch.arange(n, device=device)[:, None]
    for m, lens in full:
        cols = torch.arange(m.shape[1], device=device)[None, :]
        keep = cols < lens[:, None]
        out[rows.expand_as(m)[keep], (cur[:, None] + cols)[keep]] = m[keep]
        cur = cur + lens
    return out, cur


def _phones(d: Draw, nation: torch.Tensor):
    """Section 4.2.2.9: country code (the nation key + 10), then 3, 3 and 4
    digits."""
    n = len(nation)
    return _compose(n, [
        (_digits(nation + 10, 2), _fixed(n, 2, d.device)), b"-",
        (_digits(d.ints(100, 1000, n), 3), _fixed(n, 3, d.device)), b"-",
        (_digits(d.ints(100, 1000, n), 3), _fixed(n, 3, d.device)), b"-",
        (_digits(d.ints(1000, 10000, n), 4), _fixed(n, 4, d.device))],
        d.device)


def _fixed(n: int, width: int, device) -> torch.Tensor:
    return torch.full((n,), width, dtype=torch.int64, device=device)


def _numbered(prefix: str, values: torch.Tensor, width: int):
    n = len(values)
    return _compose(n, [prefix.encode(), (_digits(values, width),
                                          _fixed(n, width, values.device))],
                    values.device)


_SPENT = {"sort": 0.0, "strings": 0.0}   # dictionary() seconds, by part


def dictionary(mat: torch.Tensor, lens: torch.Tensor):
    """(int32 codes, sorted dictionary) of the strings of a byte matrix:
    the rows sorted as big-endian 8-byte words (a stable sort a word, the
    last word first), the distinct rows where neighbours differ, and the
    distinct values decoded from one buffer of them, a newline after
    each."""
    t0 = time.perf_counter()
    n, width = mat.shape
    dev = mat.device
    if n == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                np.asarray([], dtype=object))
    words_n = -(-width // WORD)
    padded = torch.zeros((n, words_n * WORD), dtype=torch.uint8, device=dev)
    padded[:, :width] = mat
    shifts = torch.arange(WORD * 8 - 8, -1, -8, device=dev)
    # ASCII bytes stay below 0x80, so each word is a non-negative int64
    words = (padded.view(n, words_n, WORD).to(torch.int64)
             << shifts).sum(dim=2)
    del padded
    perm = torch.arange(n, device=dev)
    for w in range(words_n - 1, -1, -1):
        perm = perm[torch.sort(words[perm, w], stable=True).indices]
    ordered = words[perm]
    del words
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = (ordered[1:] != ordered[:-1]).any(dim=1)
    del ordered
    rank = torch.cumsum(new.to(torch.int32), 0, dtype=torch.int32) - 1
    codes = torch.empty(n, dtype=torch.int32, device=dev)
    codes[perm] = rank
    first = perm[new]
    del perm, new, rank
    u = len(first)
    t1 = time.perf_counter()   # u's host read waited for the sorts
    _SPENT["sort"] += t1 - t0
    umat = torch.zeros((u, width + 1), dtype=torch.uint8, device=dev)
    umat[:, :width] = mat[first]
    ulen = lens[first]
    umat[torch.arange(u, device=dev), ulen] = ord("\n")
    keep = torch.arange(width + 1, device=dev)[None, :] <= ulen[:, None]
    blob = umat[keep].cpu().numpy().tobytes()
    del umat, keep
    values = np.empty(u, dtype=object)
    values[:] = blob.decode("ascii").split("\n")[:-1]
    _SPENT["strings"] += time.perf_counter() - t1
    return codes, values


def _text_column(d, pool, n, lo, hi):
    return dictionary(*_texts(d, pool, n, lo, hi))


def _suppkey(partkey: torch.Tensor, i, n_supp: int) -> torch.Tensor:
    """Section 4.2.3's supplier of a part: (partkey + i (S/4 + (partkey -
    1) / S)) mod S + 1."""
    return (partkey + i * (n_supp // 4 + (partkey - 1) // n_supp)) \
        % n_supp + 1


def _retail_cents(partkey: torch.Tensor) -> torch.Tensor:
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def _mark_comments(d: Draw, mat, lens, rows, word: bytes):
    """Write "Customer" and, after a filler of the comment's own text,
    `word` into the comments of the given rows (section 4.2.3's S_COMMENT
    rows)."""
    dev = mat.device
    head = b"Customer"
    k = len(rows)
    if k == 0:
        return
    room = lens[rows] - len(head) - len(word)          # >= 7: lo is 25
    gap = torch.minimum(d.ints(0, 1 << 20, k) % (room + 1), room)
    start = d.ints(0, 1 << 20, k) % (room - gap + 1)
    for at, text in ((start, head), (start + len(head) + gap, word)):
        b = torch.tensor(list(text), dtype=torch.uint8, device=dev)
        cols = at[:, None] + torch.arange(len(text), device=dev)[None, :]
        mat[rows[:, None].expand_as(cols), cols] = b.expand_as(cols)


def generate(config: dict, seed: int, device) -> Dict[str, Table]:
    """The eight tables at the configuration's sizes; the seconds its
    dictionaries took go to standard error."""
    _SPENT.update(sort=0.0, strings=0.0)
    d = Draw(seed, device)
    dev = d.device
    sizes = config["sizes"]
    n_part, n_supp = int(sizes["part"]), int(sizes["supplier"])
    n_cust, n_ord = int(sizes["customer"]), int(sizes["orders"])
    n_li, n_ps = int(sizes["lineitem"]), int(sizes["partsupp"])
    if n_ps != 4 * n_part:
        raise ValueError(f"partsupp has four rows a part: {n_ps} for "
                         f"{n_part} parts")
    sf = n_supp / 10000

    def keys(n):
        return torch.arange(1, n + 1, dtype=torch.int64, device=dev)

    def money(lo_cents, hi_cents, n):
        return d.ints(lo_cents, hi_cents + 1, n).to(torch.float64) / 100

    pool = text_pool(d, int(config["text_pool_bytes"]))

    region = (Table("region", len(REGIONS))
              .add("r_regionkey", "int64", keys(len(REGIONS)) - 1)
              .add("r_name", "utf8", *d.codes(
                  torch.arange(len(REGIONS), device=dev), REGIONS))
              .add("r_comment", "utf8",
                   *_text_column(d, pool, len(REGIONS), 31, 115)))
    nation = (Table("nation", len(NATIONS))
              .add("n_nationkey", "int64", keys(len(NATIONS)) - 1)
              .add("n_name", "utf8", *d.codes(
                  torch.arange(len(NATIONS), device=dev),
                  [nm for nm, _ in NATIONS]))
              .add("n_regionkey", "int64", torch.tensor(
                  [r for _, r in NATIONS], dtype=torch.int64, device=dev))
              .add("n_comment", "utf8",
                   *_text_column(d, pool, len(NATIONS), 31, 114)))

    s_nat = d.ints(0, len(NATIONS), n_supp)
    s_com, s_com_len = _texts(d, pool, n_supp, 25, 100)
    marked = max(1, round(5 * sf))
    chosen = torch.randperm(n_supp, generator=d.g, device=dev)[:2 * marked]
    _mark_comments(d, s_com, s_com_len, chosen[:marked], b"Complaints")
    _mark_comments(d, s_com, s_com_len, chosen[marked:], b"Recommends")
    supplier = (Table("supplier", n_supp)
                .add("s_suppkey", "int64", keys(n_supp))
                .add("s_name", "utf8", *dictionary(
                    *_numbered("Supplier#", keys(n_supp), 9)))
                .add("s_address", "utf8",
                     *dictionary(*_vstrings(d, n_supp, 10, 40)))
                .add("s_nationkey", "int64", s_nat)
                .add("s_phone", "utf8", *dictionary(*_phones(d, s_nat)))
                .add("s_acctbal", "float64", money(-99999, 999999, n_supp))
                .add("s_comment", "utf8", *dictionary(s_com, s_com_len)))
    del s_com, s_com_len

    pk = keys(n_part)
    names = torch.rand((n_part, len(COLORS)), generator=d.g,
                       device=dev).topk(5, dim=1).indices
    cbuf = torch.zeros((len(COLORS), max(map(len, COLORS))),
                       dtype=torch.uint8, device=dev)
    for i, c in enumerate(COLORS):
        cbuf[i, :len(c)] = torch.tensor(list(c.encode()), dtype=torch.uint8)
    clen = torch.tensor([len(c) for c in COLORS], device=dev)
    parts: List = []
    for k in range(5):
        if k:
            parts.append(b" ")
        parts.append((cbuf[names[:, k]], clen[names[:, k]]))
    p_name = dictionary(*_compose(n_part, parts, dev))
    del names, parts
    mfgr = d.ints(1, 6, n_part)
    brand = mfgr * 10 + d.ints(1, 6, n_part)
    types = [f"{a} {b} {c}" for a in TYPE_1 for b in TYPE_2 for c in TYPE_3]
    conts = [f"{a} {b}" for a in CONT_1 for b in CONT_2]
    part = (Table("part", n_part)
            .add("p_partkey", "int64", pk)
            .add("p_name", "utf8", *p_name)
            .add("p_mfgr", "utf8", *d.codes(
                mfgr - 1, [f"Manufacturer#{m}" for m in range(1, 6)]))
            .add("p_brand", "utf8", *d.codes(
                (brand // 10 - 1) * 5 + brand % 10 - 1,
                [f"Brand#{m}{b}" for m in range(1, 6) for b in range(1, 6)]))
            .add("p_type", "utf8", *d.pick(types, n_part))
            .add("p_size", "int64", d.ints(1, 51, n_part))
            .add("p_container", "utf8", *d.pick(conts, n_part))
            .add("p_retailprice", "float64",
                 _retail_cents(pk).to(torch.float64) / 100)
            .add("p_comment", "utf8", *_text_column(d, pool, n_part, 5, 22)))

    ps_part = pk.repeat_interleave(4)
    ps_i = torch.arange(4, device=dev).repeat(n_part)
    partsupp = (Table("partsupp", n_ps)
                .add("ps_partkey", "int64", ps_part)
                .add("ps_suppkey", "int64", _suppkey(ps_part, ps_i, n_supp))
                .add("ps_availqty", "int64", d.ints(1, 10000, n_ps))
                .add("ps_supplycost", "float64", money(100, 100000, n_ps))
                .add("ps_comment", "utf8",
                     *_text_column(d, pool, n_ps, 49, 198)))
    del ps_part, ps_i

    c_nat = d.ints(0, len(NATIONS), n_cust)
    customer = (Table("customer", n_cust)
                .add("c_custkey", "int64", keys(n_cust))
                .add("c_name", "utf8", *dictionary(
                    *_numbered("Customer#", keys(n_cust), 9)))
                .add("c_address", "utf8",
                     *dictionary(*_vstrings(d, n_cust, 10, 40)))
                .add("c_nationkey", "int64", c_nat)
                .add("c_phone", "utf8", *dictionary(*_phones(d, c_nat)))
                .add("c_acctbal", "float64", money(-99999, 999999, n_cust))
                .add("c_mktsegment", "utf8", *d.pick(SEGMENTS, n_cust))
                .add("c_comment", "utf8",
                     *_text_column(d, pool, n_cust, 29, 116)))
    del c_nat

    # orders and their lines
    idx = torch.arange(n_ord, dtype=torch.int64, device=dev)
    o_key = (idx // 8) * 32 + idx % 8 + 1
    lines = _lines_multiset(n_ord, n_li, d)
    order = torch.repeat_interleave(idx, lines)          # order of a line
    start = torch.cumsum(lines, 0) - lines
    linenumber = torch.arange(n_li, device=dev) - start[order] + 1
    del start, idx
    non3 = n_cust - n_cust // 3
    k = d.ints(0, non3, n_ord)
    o_cust = k + k // 2 + 1                  # the k-th key not a multiple of 3
    del k
    o_date = d.ints(START_DATE, END_DATE - 151 + 1, n_ord)
    l_part = d.ints(1, n_part + 1, n_li)
    l_supp = _suppkey(l_part, d.ints(0, 4, n_li), n_supp)
    qty = d.ints(1, 51, n_li)
    ext_cents = qty * _retail_cents(l_part)
    disc = d.ints(0, 11, n_li)
    tax = d.ints(0, 9, n_li)
    day = o_date[order]
    ship = day + d.ints(1, 122, n_li)
    commit = day + d.ints(30, 91, n_li)
    receipt = ship + d.ints(1, 31, n_li)
    del day
    ra = d.ints(0, 2, n_li)
    flag_raw = torch.where(receipt <= CURRENT_DATE, ra, torch.full_like(
        ra, 2))                                      # A, R or N
    del ra
    shipped = ship <= CURRENT_DATE                   # F, else O
    # the order's status: F if all its lines are F, O if all O, else P
    n_f = torch.zeros(n_ord, dtype=torch.int64, device=dev)
    n_f.index_add_(0, order, shipped.to(torch.int64))
    status = torch.where(n_f == lines, 0, torch.where(n_f == 0, 1, 2))
    del n_f
    ext = ext_cents.to(torch.float64) / 100
    del ext_cents
    discount = disc.to(torch.float64) / 100
    taxes = tax.to(torch.float64) / 100
    del disc, tax
    charge = ext * (1 + taxes) * (1 - discount)
    total = torch.zeros(n_ord, dtype=torch.float64, device=dev)
    total.index_add_(0, order, charge)
    del charge
    total = torch.round(total * 100) / 100
    orders = (Table("orders", n_ord)
              .add("o_orderkey", "int64", o_key)
              .add("o_custkey", "int64", o_cust)
              .add("o_orderstatus", "utf8", *d.codes(status, ["F", "O", "P"]))
              .add("o_totalprice", "float64", total)
              .add("o_orderdate", "date32", o_date.to(torch.int32))
              .add("o_orderpriority", "utf8",
                   *d.pick(PRIORITIES, n_ord))
              .add("o_clerk", "utf8", *d.codes(
                  d.ints(0, max(1, round(1000 * sf)), n_ord),
                  [f"Clerk#{c:09d}" for c in
                   range(1, max(1, round(1000 * sf)) + 1)]))
              .add("o_shippriority", "int64", torch.zeros(
                  n_ord, dtype=torch.int64, device=dev))
              .add("o_comment", "utf8", *_text_column(d, pool, n_ord, 19, 78)))
    del status, total, o_cust, o_date, lines
    lineitem = (Table("lineitem", n_li)
                .add("l_orderkey", "int64", o_key[order])
                .add("l_partkey", "int64", l_part)
                .add("l_suppkey", "int64", l_supp)
                .add("l_linenumber", "int64", linenumber)
                .add("l_quantity", "float64", qty.to(torch.float64))
                .add("l_extendedprice", "float64", ext)
                .add("l_discount", "float64", discount)
                .add("l_tax", "float64", taxes)
                .add("l_returnflag", "utf8", *d.codes(flag_raw,
                                                      ["A", "R", "N"]))
                .add("l_linestatus", "utf8", *d.codes(
                    (~shipped).to(torch.int64), ["F", "O"]))
                .add("l_shipdate", "date32", ship.to(torch.int32))
                .add("l_commitdate", "date32", commit.to(torch.int32))
                .add("l_receiptdate", "date32", receipt.to(torch.int32))
                .add("l_shipinstruct", "utf8", *d.pick(INSTRUCTIONS, n_li))
                .add("l_shipmode", "utf8", *d.pick(MODES, n_li))
                .add("l_comment", "utf8", *_text_column(d, pool, n_li, 10, 43)))
    print(f"[port_bench] dictionaries: {_SPENT['sort']:.3f} s sorting on "
          f"the device, {_SPENT['strings']:.3f} s making the distinct "
          "values' strings", file=sys.stderr, flush=True)
    return {t.name: t for t in (region, nation, supplier, part, partsupp,
                                customer, orders, lineitem)}
