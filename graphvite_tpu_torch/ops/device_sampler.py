"""On-device positive samples (the port of graphvite_tpu/ops/
device_sampler.py's edge and walk samplers).

Edges (augmentation_step 1): `DeviceEdgeSampler` draws each batch's
positive edges on the device, from a host-shuffled stream of 1024-edge
chunks (optionally sorted by head id), uniformly, or by edge weight.

Walks: walks start from alias-sampled edges and step through per-vertex
alias tables over out-edge weights; they truncate at dead ends (the
reference's graph.cuh:376-450 semantics). On the card the first-order
chain is one hand-written kernel (`walk_chain`, csrc/walk_chain.cu),
bit-equal to its plain version from the same draws. node2vec's second-order walks
take the same first-order step as a proposal and accept it by rejection
(bias 1/p for a return to the previous vertex, 1 for a common neighbor,
1/q otherwise), with a membership test on the host-built cuckoo table or
a binary search over row-sorted CSR indices. Three emitters: banded (whole
walks, one pair-validity mask per (position, offset)), position-major (one
sample per walk position carrying its T tails) and pairs.

Random draws: the sample and chain functions take their random numbers as
optional inputs (`draws`), so a test can feed them the JAX reference's own
draws and get the same samples; otherwise they draw from an explicit
`torch.Generator` on the arrays' device.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import os

import numpy as np
import torch

from graphvite_tpu_torch.ops import kernels
from graphvite_tpu_torch.ops.alias import (AliasTable, PackedAliasTables,
                                           alias_draws, device_alias_arrays,
                                           device_sample)
from graphvite_tpu_torch.utils import tracing


@dataclasses.dataclass
class DeviceEdgeSampler:
    """Positive edges on the device, in one of four modes:

    * streamed (unweighted graphs with at least MIN_STREAM_BLOCKS chunks of
      edges): the packed [E, 2] (head, tail) array ([E, 3] with the
      relation, for knowledge graphs) is shuffled on the host
      once, padded with re-drawn edges to whole STREAM_CHUNK blocks, and
      each batch gathers ceil(B / 1024) random whole blocks;
    * sorted stream (`sort_stream`, or GRAPHVITE_SORTED_STREAM=1): the
      shuffled stream is also stable-sorted by head id, so sorting the
      drawn block ids gives a batch whose heads ascend (the copies of a
      block drawn more than once are interleaved to keep it so); where B
      is not a multiple of 1024, the batch is rotated by a uniform offset
      before truncation, so truncation drops every row with equal
      probability, and leaves two ascending runs;
    * uniform random edges (unweighted, too few edges to stream);
    * alias-weighted edges (weighted graphs).

    The host shuffle uses the reference's np.random.default_rng(0x5eed ^
    num_edge), so the stream is the reference's, bit for bit."""

    STREAM_CHUNK = 1024
    MIN_STREAM_BLOCKS = 64   # enough blocks for batch diversity

    edges: torch.Tensor      # [E, 2|3] int32, or [nblocks, C, 2|3] streamed
    alias_arrays: tuple      # () uniform | (packed,) | (prob, alias)
    num_edge: int
    uniform: bool
    with_rel: bool = False
    streamed: bool = False
    sorted_stream: bool = False

    @classmethod
    @tracing.setup_stage(tracing.SAMPLER_BUILD)
    def build(cls, graph, with_relation=False, sort_stream=None,
              device="cpu"):
        w = graph.edge_weights
        w = w.cpu().numpy() if torch.is_tensor(w) else np.asarray(w)
        uniform = bool(w.size == 0 or np.all(w == w[0]))
        alias_arrays = () if uniform else device_alias_arrays(AliasTable(w))
        del w
        cols = [graph.edge_heads, graph.edge_tails]
        if with_relation:
            cols.append(graph.edge_relations)
        n_edge = int(cols[0].shape[0])
        C = cls.STREAM_CHUNK
        streamed = uniform and n_edge >= C * cls.MIN_STREAM_BLOCKS
        if all(torch.is_tensor(c) for c in cols) and not streamed:
            # device edge arrays (KNNGraph) stay on the device
            return cls(
                edges=torch.stack([c.to(device=device, dtype=torch.int32)
                                   for c in cols], dim=1),
                alias_arrays=tuple(torch.as_tensor(a, device=device)
                                   for a in alias_arrays),
                num_edge=n_edge, uniform=uniform,
                with_rel=bool(with_relation))
        packed = np.stack([c.cpu().numpy().astype(np.int32)
                           if torch.is_tensor(c) else np.asarray(c, np.int32)
                           for c in cols], axis=1)
        if sort_stream is None:
            sort_stream = os.environ.get("GRAPHVITE_SORTED_STREAM",
                                         "0") != "0"
        sorted_stream = bool(streamed and sort_stream)
        if streamed:
            rng = np.random.default_rng(0x5eed ^ n_edge)
            packed = packed[rng.permutation(n_edge)]
            pad = (-n_edge) % C
            if pad:
                # re-drawn edges; their ~C/E over-weight is negligible
                packed = np.concatenate(
                    [packed, packed[rng.integers(0, n_edge, pad)]])
            if sorted_stream:
                # stable: within a head, the shuffled order stays
                packed = packed[np.argsort(packed[:, 0], kind="stable")]
            packed = packed.reshape(-1, C, packed.shape[1])
        return cls(
            edges=torch.as_tensor(packed, device=device),
            alias_arrays=tuple(torch.as_tensor(a, device=device)
                               for a in alias_arrays),
            num_edge=n_edge, uniform=uniform, with_rel=bool(with_relation),
            streamed=streamed, sorted_stream=sorted_stream)

    def arrays(self):
        return (self.edges,) + self.alias_arrays

    def make_sample_fn(self, batch_size: int):
        """fn(edges, *alias_arrays, generator=None, draws=None) -> (heads
        [B] int32, tails [B] int32, mask [B] float32 ones), with the
        relations [B] int32 before the mask when built `with_relation`.
        `draws` replaces the generator's numbers: (block ids
        [ceil(B/1024)], roll shift or None) when streamed, edge ids [B]
        when uniform, (u1, u2) [B] when weighted."""
        B = int(batch_size)
        C = self.STREAM_CHUNK
        streamed, sorted_stream = self.streamed, self.sorted_stream
        uniform, n_edge = self.uniform, self.num_edge
        with_rel = self.with_rel

        def sample(edges, *alias_arrays, generator=None, draws=None):
            dev = edges.device
            if streamed:
                nb = -(-B // C)
                roll = sorted_stream and B % C
                if draws is None:
                    bid = torch.randint(0, edges.shape[0], (nb,),
                                        generator=generator, device=dev)
                    shift = (torch.randint(0, nb * C, (), generator=generator,
                                           device=dev) if roll else None)
                else:
                    bid, shift = draws
                if sorted_stream:
                    # blocks are disjoint slices of a head-sorted array:
                    # block-id order is head order
                    bid = torch.sort(bid).values
                row = edges[bid].reshape(nb * C, -1)
                if sorted_stream:
                    row = _interleave_repeats(row, bid, C)
                if roll:
                    idx = (torch.arange(nb * C, device=dev) + shift) % (nb * C)
                    row = row[idx]
                row = row[:B]
            elif uniform:
                eid = draws if draws is not None else torch.randint(
                    0, n_edge, (B,), generator=generator, device=dev)
                row = edges[eid]
            else:
                if draws is None:
                    draws = alias_draws(alias_arrays, (B,), generator, dev)
                row = edges[device_sample(*alias_arrays, *draws)]
            cols = row.t().contiguous()
            mask = torch.ones(B, dtype=torch.float32, device=dev)
            if with_rel:
                return cols[0], cols[1], cols[2], mask
            return cols[0], cols[1], mask

        return sample


def _interleave_repeats(row, bid, C):
    """Rows [nb * C, 2] of the ascending block ids `bid`, reordered so that
    a block drawn k times contributes each of its rows k times in a row:
    the batch then ascends by head even when a block repeats (the
    reference concatenates the copies, which leaves its batch unsorted; at
    97 draws of 44k blocks about one batch in ten repeats a block). The
    identity when no block repeats. Runs on the device, no host sync."""
    nb = bid.shape[0]
    first = torch.searchsorted(bid, bid)
    mult = torch.searchsorted(bid, bid, right=True) - first
    rank = torch.arange(nb, device=bid.device) - first
    col = torch.arange(C, device=bid.device)
    dest = (first * C + rank)[:, None] + col[None, :] * mult[:, None]
    out = torch.empty_like(row)
    out[dest.reshape(-1)] = row
    return out


_U32 = 0xFFFFFFFF


def _mul32(x, c):
    """x * c mod 2^32 for int64 tensors x in [0, 2^32) and a uint32
    constant c. A constant above 2^31 enters as c - 2^32 (the same residue
    mod 2^32), so |x * c| < 2^63 and the int64 product never overflows."""
    if c >= 1 << 31:
        c -= 1 << 32
    return (x * c) & _U32


def _cuckoo_mix(x):
    """The uint32 avalanche of native/sampler.cpp gv_mix32, bit for bit, on
    int64 tensors holding values in [0, 2^32) (torch has no right shift
    for uint32; a masked non-negative int64 shifts logically)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7feb352d)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846ca68b)
    x = x ^ (x >> 16)
    return x


def _cuckoo_buckets(u, v, mask):
    """Bucket ids (h1, h2) of the directed edge (u, v); mirrors gv_h1 and
    gv_h2. u, v: integer tensors (their uint32 bits are hashed); mask:
    num_buckets - 1. Returns int64 tensors."""
    uu = u.long() & _U32
    vv = v.long() & _U32
    b1 = _cuckoo_mix(_mul32(uu, 0x9E3779B9) ^ _cuckoo_mix(vv)) & mask
    b2 = _cuckoo_mix(_mul32(vv, 0x85EBCA6B)
                     ^ _cuckoo_mix(uu ^ 0x5bd1e995)) & mask
    return b1, b2


def n2v_proposals(p, q, membership):
    """R, the proposals per rejection round of node2vec's walk step: the
    reference's auto rule (R = 1 when the dominant "else" class accepts at
    a_est = (1/q) / max_bias >= 0.8; else 8 on the cuckoo membership, else
    2^ceil(log2(1/a_est)) capped at 8), or GRAPHVITE_N2V_PROPOSALS. R sets
    the shape of the step's draws, so it must be the reference's exactly."""
    env = os.environ.get("GRAPHVITE_N2V_PROPOSALS", "")
    if env:
        return max(int(env), 1)
    max_bias = max(1.0, 1.0 / p, 1.0 / q)
    a_est = (1.0 / q) / max_bias
    if a_est >= 0.8:
        return 1
    if membership == "cuckoo":
        return 8
    return min(8, 2 ** int(math.ceil(math.log2(1.0 / a_est))))


def _accept_thresholds(p, q):
    """bias / max_bias for (return, common neighbor, other), each computed
    in float32 as the reference's float32 arrays compute it."""
    max_bias = np.float32(max(1.0, 1.0 / p, 1.0 / q))
    return tuple(float(np.float32(b) / max_bias)
                 for b in (1.0 / p, 1.0, 1.0 / q))


def _start_column(u1, n):
    """A start column over [0, n): an integer draw as it is (every column
    reachable), or the reference's float rule min(int(u1 * n), n - 1),
    which reaches at most 2^24 columns."""
    if not u1.is_floating_point():
        return u1.long()
    return torch.clamp((u1 * n).long(), max=n - 1)


def _alias_pick(prob, alias, u1, u2, n=None):
    """Walker alias decision on device tensors over `n` columns (prob's
    length by default): the column `u1` (`_start_column`) is kept where u2
    < its prob, else its alias is taken. An empty `prob` is the table of
    equal weights, every prob 1: the column itself."""
    idx = _start_column(u1, prob.shape[0] if n is None else n)
    if prob.numel() == 0:
        return idx
    return torch.where(u2 < prob[idx], idx, alias[idx].long())


def _pick(start, deg, indices, nbr_prob, nbr_alias, u1, u2, uniform):
    """CSR position of a first-order alias step from rows (start, deg);
    start/deg broadcast against the draws u1/u2."""
    safe_deg = torch.clamp(deg, min=1)
    idx = torch.minimum((u1 * safe_deg).long(), (safe_deg - 1).long())
    # a dead vertex's row start may be the end of `indices`: clamp the
    # gathers (their result is discarded for dead lanes)
    last = max(indices.shape[0] - 1, 0)
    flat = torch.clamp(start + idx, max=last)
    if not uniform:
        local = torch.where(u2 < nbr_prob[flat], idx,
                            nbr_alias[flat].long())
        flat = torch.clamp(start + local, max=last)
    return flat


def _num_starts(heads, indices, start_csr):
    """The start columns: CSR positions, or flat directed edges."""
    return max(int(indices.shape[0] if start_csr else heads.shape[0]), 1)


def _chain_start(edge_prob, edge_alias, heads, tails, indices, u1, u2,
                 start_csr):
    """(v0, v1) int64 [W]: each lane's start edge (make_walk_chain_fn)."""
    n_start = _num_starts(heads, indices, start_csr)
    if start_csr:
        eid = _start_column(u1, n_start)
        v0 = torch.searchsorted(heads, eid, right=True) - 1
        v1 = indices[eid].long()
    else:
        eid = _alias_pick(edge_prob, edge_alias, u1, u2, n_start)
        v0 = heads[eid].long()
        v1 = tails[eid].long()
    return v0, v1


def walk_chain_plain(edge_prob, edge_alias, heads, tails, vdeg, indices,
                     nbr_prob, nbr_alias, u1, u2, w1s, w2s, start_csr=False):
    """The first-order chain in plain PyTorch on any device (the CPU's
    path; what the kernel is held to): `walk_chain`'s arguments and
    result, one eager step a position."""
    uniform = nbr_prob.numel() == 0
    v0, v1 = _chain_start(edge_prob, edge_alias, heads, tails, indices, u1,
                          u2, start_csr)
    steps, alives = [], []
    v = v1
    alive = torch.ones_like(v1, dtype=torch.bool)
    for i in range(w1s.shape[0]):
        row = vdeg[v]
        start = row[..., 0].long()
        deg = row[..., 1]
        step_alive = deg > 0
        nxt = indices[_pick(start, deg, indices, nbr_prob, nbr_alias,
                            w1s[i], w2s[i], uniform)].long()
        # alive is cumulative: a lane at a dead end stays there
        alive = alive & step_alive
        v = torch.where(alive, nxt, v)
        steps.append(v)
        alives.append(alive)
    chain = torch.stack([v0, v1] + steps)
    ones = torch.ones_like(alive)
    return chain, torch.stack([ones, ones] + alives)


@functools.lru_cache(maxsize=None)
def _chain_library():
    lib = kernels.library("walk_chain")
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.gv_walk_chain.argtypes = ([vp, i] + [vp] * 5 + [i, i, vp, vp, i64, vp,
                                                       vp, i64, vp, vp, i,
                                                       i64, ctypes.c_float,
                                                       i, i, vp, vp, vp])
    lib.gv_walk_chain.restype = i
    return lib


def _check_chain(edge_prob, edge_alias, heads, tails, vdeg, indices,
                 nbr_prob, nbr_alias, u1, u2, w1s, w2s, start_csr):
    """Raise on inputs the chain kernel does not take."""
    def want(name, t, dtypes, numel=None):
        if t is None or t.dtype not in dtypes:
            raise TypeError("walk_chain: %s must be %s, not %s"
                            % (name, "/".join(map(str, dtypes)),
                               None if t is None else t.dtype))
        if t.device != u1.device:
            raise ValueError("walk_chain: %s on %s, u1 on %s"
                             % (name, t.device, u1.device))
        if not t.is_contiguous():
            raise ValueError("walk_chain needs a contiguous %s" % name)
        if numel is not None and t.numel() != numel:
            raise ValueError("walk_chain: %s has %d entries, not %d"
                             % (name, t.numel(), numel))

    i32, i64, f32 = (torch.int32,), (torch.int64,), (torch.float32,)
    W = u1.shape[0]
    want("u1", u1, (torch.float32, torch.int64), W)
    if u1.dim() != 1 or not 0 < W < 2**31:
        raise ValueError("walk_chain: u1 must be [W], 0 < W < 2^31; got %s"
                         % (tuple(u1.shape),))
    if w1s.dim() != 2 or w1s.shape[1] != W or w2s.shape != w1s.shape:
        raise ValueError("walk_chain: w1s and w2s must be [L-1, %d]; got "
                         "%s, %s" % (W, tuple(w1s.shape), tuple(w2s.shape)))
    want("w1s", w1s, f32)
    want("w2s", w2s, f32)
    want("vdeg", vdeg, i64)
    if vdeg.dim() != 2 or vdeg.shape[1] != 2 or vdeg.data_ptr() % 16:
        raise ValueError("walk_chain: vdeg must be [V, 2], 16-byte aligned")
    want("indices", indices, i32)
    if indices.dim() != 1 or indices.numel() == 0:
        raise ValueError("walk_chain: indices must be [Ed], Ed > 0")
    if nbr_prob.numel():
        want("nbr_prob", nbr_prob, f32, indices.numel())
        want("nbr_alias", nbr_alias, i32, indices.numel())
    if start_csr:
        want("heads (row starts)", heads, i64)
        if heads.dim() != 1 or heads.numel() == 0:
            raise ValueError("walk_chain: row starts must be [V], V > 0")
        return
    want("heads", heads, i32)
    if heads.dim() != 1 or heads.numel() == 0:
        raise ValueError("walk_chain: heads must be [E], E > 0")
    want("tails", tails, i32, heads.numel())
    if edge_prob.numel():
        want("edge_prob", edge_prob, f32, heads.numel())
        want("edge_alias", edge_alias, (torch.int32, torch.int64),
             heads.numel())
        want("u2", u2, f32, W)


def walk_chain(edge_prob, edge_alias, heads, tails, vdeg, indices, nbr_prob,
               nbr_alias, u1, u2, w1s, w2s, start_csr=False):
    """The first-order walk chain from its draws: (chain [L+1, W] int64,
    valid [L+1, W] bool), L - 1 = w1s.shape[0] steps; the arrays and draws
    as make_walk_chain_fn takes them (an empty nbr_prob: equal weights).

    On a CUDA tensor it launches the hand-written kernel of
    graphvite_tpu_torch/csrc/walk_chain.cu (built with nvcc for sm_90a at
    first use, bound with ctypes): one thread a lane, every step in one
    launch, bit-equal to `walk_chain_plain` from the same draws, or raises
    on inputs it does not take (`walk_chain.launches` and the
    `graphvite::walk_chain_kernel` counter count its launches); on a CPU
    tensor it runs `walk_chain_plain`."""
    if u1.device.type == "cpu":
        return walk_chain_plain(edge_prob, edge_alias, heads, tails, vdeg,
                                indices, nbr_prob, nbr_alias, u1, u2, w1s,
                                w2s, start_csr)
    if u1.device.type != "cuda":
        raise ValueError("walk_chain runs on CUDA or CPU tensors, not %s"
                         % u1.device)
    w1s, w2s = w1s.contiguous(), w2s.contiguous()
    _check_chain(edge_prob, edge_alias, heads, tails, vdeg, indices,
                 nbr_prob, nbr_alias, u1, u2, w1s, w2s, start_csr)
    W, L = u1.shape[0], w1s.shape[0] + 1
    chain = torch.empty((L + 1, W), dtype=torch.int64, device=u1.device)
    valid = torch.empty((L + 1, W), dtype=torch.bool, device=u1.device)
    _launch_chain(chain, valid, edge_prob, edge_alias, heads, tails, vdeg,
                  indices, nbr_prob, nbr_alias, u1, u2, w1s, w2s, start_csr)
    walk_chain.launches += 1
    tracing.count(tracing.WALK_CHAIN_KERNEL, 1)
    return chain, valid


walk_chain.launches = 0


def _launch_chain(chain, valid, edge_prob, edge_alias, heads, tails, vdeg,
                  indices, nbr_prob, nbr_alias, u1, u2, w1s, w2s, start_csr):
    """The kernel into chain and valid, on checked inputs (`walk_chain`;
    chip_smoke.py times it alone)."""
    lib = _chain_library()
    n_start = _num_starts(heads, indices, start_csr)
    with torch.cuda.device(u1.device):
        kernels.check_launch(lib, lib.gv_walk_chain(
            u1.data_ptr(), int(u1.is_floating_point()),
            None if u2 is None else u2.data_ptr(), w1s.data_ptr(),
            w2s.data_ptr(), edge_prob.data_ptr(), edge_alias.data_ptr(),
            2 if start_csr else int(edge_prob.numel() > 0),
            int(edge_alias.dtype == torch.int64), heads.data_ptr(),
            tails.data_ptr(), heads.shape[0], vdeg.data_ptr(),
            indices.data_ptr(), indices.shape[0], nbr_prob.data_ptr(),
            nbr_alias.data_ptr(), int(nbr_prob.numel() == 0), n_start,
            float(np.float32(n_start)), u1.shape[0], w1s.shape[0] + 1,
            chain.data_ptr(), valid.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "walk_chain")


def make_walk_chain_fn(uniform, walk_length, num_walk, biased=False, p=1.0,
                       q=1.0, bs_iters=32, membership="search",
                       start_csr=False):
    """Walk generator: first-order walks, or node2vec's biased walks.

    Returned fn(edge_prob, edge_alias, heads, tails, vdeg, indices,
    nbr_prob, nbr_alias, [memb], *, generator=None, draws=None,
    with_rounds=False) -> (chain [L+1, W] int64, valid [L+1, W] bool),
    where vdeg is the packed [V, 2] (CSR row start, degree) array, int64
    (row starts past 2^31 edges), `memb` (biased walks only) the
    membership structure (a [M, 4] cuckoo table or the row-sorted CSR
    indices) and valid[j] means all steps up to position j were alive.

    The start edge: a column of the flat directed edges (heads, tails),
    kept or aliased by the start-edge table (edge_prob, edge_alias; empty
    on a graph of equal weights, where every prob is 1). `start_csr`
    (unweighted graphs): the start edge is a CSR position e instead, its
    head found by a binary search over the int64 row starts, which take
    the place of `heads` ([V], sorted), its tail indices[e]; edge_prob,
    edge_alias and tails are empty. The distribution over directed edges
    is the same (uniform); a given draw picks another edge than the flat
    pick does.

    `draws` replaces the generator's numbers, in the reference's order:
    (u1 [W], u2 [W], w1s [L-1, W], w2s [L-1, W]) for first-order walks;
    (u1 [W], u2 [W], props [L-1, C, 3, R, W]) for biased walks, with C =
    64 // R rounds of R proposals, each (neighbor draw, alias draw,
    acceptance draw). A float u1 takes the reference's start rule
    (`_start_column`); drawing for itself, the chain takes an integer
    column (u1 int64 [W]) and, on equal weights, no u2.

    First-order walks run through `walk_chain` (one kernel launch on the
    card; its neighbour picks alias where nbr_prob is not empty). The
    biased step is the reference's rejection sampler (an exact
    alternative to per-edge second-order alias tables): R first-order
    proposals per round, accepted with probability bias / max_bias, a lane
    taking its first accepted proposal in (round, proposal) order; a lane
    with none in C rounds stays where it is, and stays alive. The
    reference runs the rounds as a lockstep loop that stops once every
    lane has accepted; since a lane's draws do not depend on the loop, all
    C rounds are evaluated here in one pass, with no host sync, and give
    the same chain. `with_rounds` also returns the rounds each lane used
    per step, [L-1, W] int64 (0 for lanes at a dead end, C for lanes that
    never accepted; None for first-order walks)."""
    L, W = int(walk_length), int(num_walk)
    if biased:
        R = n2v_proposals(p, q, membership)
        C = 64 // R
        t_ret, t_com, t_other = _accept_thresholds(p, q)

    def cuckoo_member(ctable, x, u):
        """Edge x -> u in the bucketized cuckoo table: two [4]-row gathers
        (native/sampler.cpp builds it)."""
        b1, b2 = _cuckoo_buckets(x, u, ctable.shape[0] - 1)
        hit = None
        for b in (b1, b2):
            r = ctable[b].long()
            h = (((r[..., 0] == x) & (r[..., 1] == u))
                 | ((r[..., 2] == x) & (r[..., 3] == u)))
            hit = h if hit is None else hit | h
        return hit

    def search_member(vdeg, sorted_idx, x, u):
        """u in N(x) by binary search over the row-sorted CSR indices,
        `bs_iters` halvings."""
        row = vdeg[x]
        lo = row[..., 0].long()
        hi0 = lo + row[..., 1].long()
        hi = hi0
        last = max(sorted_idx.shape[0] - 1, 0)
        for _ in range(bs_iters):
            mid = (lo + hi) // 2
            val = sorted_idx[torch.clamp(mid, max=last)].long()
            open_ = lo < hi
            go_right = (val < u) & open_
            lo, hi = (torch.where(go_right, mid + 1, lo),
                      torch.where(~go_right & open_, mid, hi))
        found = sorted_idx[torch.clamp(lo, max=last)].long() == u
        return found & (lo < hi0)

    def biased_step(vdeg, indices, nbr_prob, nbr_alias, memb, v, prev,
                    props):
        """One node2vec step of every lane from v (previous vertex prev)
        with the step's proposal draws props [C, 3, R, W]; returns (next,
        step alive, rounds used)."""
        row = vdeg[v]
        start = row[:, 0].long()
        deg = row[:, 1]
        step_alive = deg > 0
        w1, w2, racc = props.unbind(1)                       # [C, R, W]
        flat = _pick(start, deg, indices, nbr_prob, nbr_alias, w1, w2,
                     uniform)
        cand = torch.where(step_alive, indices[flat].long(), v)
        # the reference tests edge cand -> prev (graph.cuh:668)
        if membership == "cuckoo":
            is_common = cuckoo_member(memb, cand, prev)
        else:
            is_common = search_member(vdeg, memb, cand, prev)
        thr = torch.where(cand == prev, t_ret,
                          torch.where(is_common, t_com, t_other))
        ok = (racc < thr).reshape(C * R, -1)
        order = torch.arange(C * R, device=v.device)[:, None]
        first = torch.where(ok, order, C * R).amin(dim=0)
        # dead lanes never move; a lane with no accepted proposal stays
        take = (first < C * R) & step_alive
        chosen = cand.reshape(C * R, -1).gather(
            0, torch.clamp(first, max=C * R - 1)[None])[0]
        nxt = torch.where(take, chosen, v)
        rounds = torch.where(take, first // R + 1,
                             torch.where(step_alive, C, 0))
        return nxt, step_alive, rounds

    def chain_fn(edge_prob, edge_alias, heads, tails, vdeg, indices,
                 nbr_prob, nbr_alias, *rest, generator=None, draws=None,
                 with_rounds=False):
        if draws is None:
            dev = heads.device

            def rand(*shape):
                return torch.rand(shape, generator=generator, device=dev)

            first = torch.randint(0, _num_starts(heads, indices, start_csr),
                                  (W,), generator=generator, device=dev)
            u2 = rand(W) if edge_prob.numel() else None
            if biased:
                draws = (first, u2, rand(L - 1, C, 3, R, W))
            else:
                draws = (first, u2, rand(L - 1, W), rand(L - 1, W))
        u1, u2 = draws[:2]
        if not biased:
            # looked up at each call, so a test can swap in the plain body
            chain, valid = walk_chain(edge_prob, edge_alias, heads, tails,
                                      vdeg, indices, nbr_prob, nbr_alias,
                                      u1, u2, draws[2][:L - 1],
                                      draws[3][:L - 1], start_csr)
            return (chain, valid, None) if with_rounds else (chain, valid)
        v0, v1 = _chain_start(edge_prob, edge_alias, heads, tails, indices,
                              u1, u2, start_csr)
        steps, alives, used = [], [], []
        v, prev = v1, v0
        alive = torch.ones_like(v1, dtype=torch.bool)
        for i in range(L - 1):
            nxt, step_alive, rounds = biased_step(
                vdeg, indices, nbr_prob, nbr_alias, rest[0], v, prev,
                draws[2][i])
            used.append(rounds)
            alive = alive & step_alive
            prev = torch.where(alive, v, prev)
            v = torch.where(alive, nxt, v)
            steps.append(v)
            alives.append(alive)
        chain = torch.stack([v0, v1] + steps)
        alive_all = torch.stack(
            [torch.ones_like(alive), torch.ones_like(alive)] + alives)
        # cumulative validity: position j valid iff all steps up to j alive
        valid = torch.cumprod(alive_all.int(), dim=0) > 0
        if with_rounds:
            return chain, valid, (torch.stack(used) if used else None)
        return chain, valid

    if biased:
        chain_fn.proposals, chain_fn.rounds_cap = R, C
    return chain_fn


def _start_table(weights):
    """(prob float32, alias) of the start-edge alias table over the flat
    directed edges' weights."""
    w = weights.cpu().numpy() if torch.is_tensor(weights) else weights
    t = AliasTable(w)
    return t.prob.astype(np.float32), t.alias


def walk_offsets(aug, bidir=False):
    """Augmentation tail offsets shared by the position-major and banded
    emitters and their steps (order is part of the contract: pmask[..., t]
    refers to offsets[t])."""
    offs = list(range(1, aug + 1))
    if bidir:
        offs += [-k for k in range(1, aug + 1)]
    return offs


def emit_walk_banded(chain, valid, aug, bidir=False):
    """Banded emission: whole walks, one pair-validity mask per (position,
    offset). Returns (chainT [W, L+1], pmask [W, L+1, T] float32):
    pmask[w, i, t] flags pair (chain[i], chain[i + offsets[t]])."""
    L1, W = chain.shape
    zeros = torch.zeros((L1, W), dtype=torch.bool, device=chain.device)
    ms = []
    for k in walk_offsets(aug, bidir):
        m = zeros.clone()
        if k > 0:
            m[: L1 - k] = valid[k:] & valid[: L1 - k]
        else:
            m[-k:] = valid[:k] & valid[-k:]
        ms.append(m)
    pmask = torch.stack(ms, dim=-1).transpose(0, 1)          # [W, L1, T]
    return chain.t().contiguous(), pmask.float().contiguous()


def emit_walk_positions(chain, valid, aug, bidir=False):
    """Position-major emission: one sample per walk position, carrying all
    its augmentation tails. Returns (heads [P], tails [P, T], tmask [P, T]
    bool) with P = W * (L+1) and T = aug (2 * aug with `bidir`, whose
    negative offsets emit the reversed pairs); tails past either end of a
    walk are 0 with mask False."""
    L1, W = chain.shape
    ts, ms = [], []
    for k in walk_offsets(aug, bidir):
        t = torch.zeros_like(chain)
        m = torch.zeros_like(valid)
        if k > 0:
            t[: L1 - k] = chain[k:]
            m[: L1 - k] = valid[k:] & valid[: L1 - k]
        else:
            t[-k:] = chain[:k]
            m[-k:] = valid[:k] & valid[-k:]
        ts.append(t)
        ms.append(m)
    heads = chain.t().reshape(-1)                           # [W * L1]
    tails = torch.stack(ts, dim=-1).transpose(0, 1).reshape(W * L1, -1)
    tmask = torch.stack(ms, dim=-1).transpose(0, 1).reshape(W * L1, -1)
    return heads, tails, tmask


def emit_walk_pairs(chain, valid, aug):
    """Every (v_j, v_{j+k}) pair for k = 1..aug, walk-major ([W,
    pairs_per_walk] flattened, so a truncated batch drops whole trailing
    walks). Returns (heads, tails, mask bool), each [W * pairs_per_walk]."""
    L1 = chain.shape[0]
    hs, ts, ms = [], [], []
    for k in range(1, aug + 1):
        hs.append(chain[: L1 - k].t())                      # [W, L1-k]
        ts.append(chain[k:].t())
        ms.append((valid[: L1 - k] & valid[k:]).t())
    return (torch.cat(hs, dim=1).reshape(-1), torch.cat(ts, dim=1).reshape(-1),
            torch.cat(ms, dim=1).reshape(-1))


@dataclasses.dataclass
class DeviceWalkSampler:
    """Random-walk augmented pairs, generated on the device, in one of three
    layouts:

    * banded: W whole walks, W = batch_size / (T * (L+1)) with T = aug
      (2 * aug with `bidir`); the sample is (chainT, chainT, pmask);
    * position-major: batch_size / T walk positions, each with its T tails
      and a [T] mask, from ceil(batch_size / T / (L+1)) walks;
    * pairs: batch_size (head, tail) pairs with a mask, from enough walks
      to cover the batch (truncated walk-major).

    node2vec (`biased`): second-order walks with p and q, their membership
    structure `memb` a [M, 4] cuckoo table (the default) or the row-sorted
    CSR indices ("search": GRAPHVITE_N2V_CUCKOO=0, no g++ for the native
    build, or a table above GRAPHVITE_CUCKOO_MAX_BYTES).

    Walk starts: uniform over the directed edges on a graph of equal
    weights (no start-edge alias table: every prob is 1), alias-weighted
    otherwise. `start_csr` (unweighted graphs; make_walk_chain_fn) keeps
    no flat edge arrays: the start edge is a CSR position, `heads` holds
    the int64 row starts, and `edge_prob`, `edge_alias` and `tails` are
    empty, so the state is the CSR indices and 24 bytes a vertex."""

    edge_prob: torch.Tensor     # [E] f32   (walk start edges; [0] uniform)
    edge_alias: torch.Tensor    # [E] i32, i64 past 2^31 edges
    heads: torch.Tensor         # [E] i32; start_csr: [V] i64 row starts
    tails: torch.Tensor         # [E] i32; start_csr: [0]
    vdeg: torch.Tensor          # [V, 2] i64: packed (CSR row start, degree)
    indices: torch.Tensor       # [Ed] i32
    nbr_prob: torch.Tensor      # [Ed] f32  per-vertex packed alias (or empty)
    nbr_alias: torch.Tensor     # [Ed] i32
    uniform: bool
    walk_length: int
    augmentation_step: int
    batch_size: int
    num_walk: int
    p: float = 1.0
    q: float = 1.0
    biased: bool = False
    bs_iters: int = 32
    memb: torch.Tensor = None   # biased: [M, 4] i32 cuckoo table, or [Ed] i32
    #                             CSR indices with each row sorted
    membership: str = "search"  # "cuckoo" | "search"
    position_major: bool = False
    bidir: bool = False
    num_tail: int = 0
    banded: bool = False
    start_csr: bool = False

    @classmethod
    @tracing.setup_stage(tracing.SAMPLER_BUILD)
    def build(cls, graph, augmentation_step, walk_length, batch_size,
              biased=False, p=1.0, q=1.0, position_major=False, bidir=False,
              banded=False, device="cpu", start_csr=False, membership=None):
        """The sampler of `graph` on `device`. `start_csr` takes the start
        edge as a CSR position (unweighted graphs only); `membership`
        "search" forces node2vec's sorted-indices membership (None: the
        cuckoo table where it builds)."""
        w = graph.csr_weights
        uniform = bool(w.size == 0 or np.all(w == w[0]))
        if start_csr and not uniform:
            raise ValueError("a CSR start edge needs equal edge weights")
        if uniform:
            nbr_prob = np.zeros(0, np.float32)
            nbr_alias = np.zeros(0, np.int32)
        else:
            packed = PackedAliasTables(np.asarray(w, np.float64),
                                       graph.indptr)
            nbr_prob = packed.prob.astype(np.float32)
            nbr_alias = packed.alias.astype(np.int32)
        indptr = np.asarray(graph.indptr, np.int64)
        L, aug = int(walk_length), int(augmentation_step)

        def up(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        empty_f = up(np.zeros(0, np.float32), torch.float32)
        empty_i = up(np.zeros(0, np.int32), torch.int32)
        if start_csr:
            start = dict(edge_prob=empty_f, edge_alias=empty_i,
                         heads=up(indptr[:-1], torch.int64), tails=empty_i,
                         start_csr=True)
        else:
            n_edge = int(np.asarray(graph.edge_heads).size)
            # no alias table over equal weights: every prob is 1
            prob, alias = ((np.zeros(0, np.float32), np.zeros(0, np.int32))
                           if uniform else _start_table(graph.edge_weights))
            start = dict(edge_prob=up(prob, torch.float32),
                         edge_alias=up(alias, torch.int32 if n_edge < 2**31
                                       else torch.int64),
                         heads=up(graph.edge_heads, torch.int32),
                         tails=up(graph.edge_tails, torch.int32))

        kw = {}
        if banded:
            T = aug * (2 if bidir else 1)
            slot_unit = T * (L + 1)
            if batch_size % slot_unit:
                raise ValueError(
                    "batch_size %d must be a multiple of the per-walk slot "
                    "count %d (= tails %d x positions %d)"
                    % (batch_size, slot_unit, T, L + 1))
            num_walk = max(batch_size // slot_unit, 1)
            kw.update(banded=True, bidir=bool(bidir), num_tail=T)
        elif position_major:
            T = aug * (2 if bidir else 1)
            if batch_size % T:
                raise ValueError("batch_size %d must be a multiple of the "
                                 "tail count %d" % (batch_size, T))
            num_walk = max(int(math.ceil(batch_size // T / (L + 1))), 1)
            kw.update(position_major=True, bidir=bool(bidir), num_tail=T)
        else:
            pairs_per_walk = sum(L + 1 - k for k in range(1, aug + 1))
            num_walk = max(int(math.ceil(batch_size / pairs_per_walk)), 1)
        if biased:
            deg = np.diff(indptr)
            max_deg = int(deg.max()) if deg.size else 1
            kw.update(biased=True, p=float(p), q=float(q),
                      bs_iters=max(int(math.ceil(math.log2(max_deg + 1)))
                                   + 1, 1))
            ctable = None
            if (membership != "search"
                    and os.environ.get("GRAPHVITE_N2V_CUCKOO", "1") != "0"):
                ctable = cls._build_cuckoo(graph)
            if ctable is not None:
                kw.update(membership="cuckoo", memb=up(ctable, torch.int32))
            else:
                # lexsort by (source, neighbor): rows stay contiguous,
                # neighbors ascend within a row
                order = np.lexsort(
                    (graph.indices, np.repeat(np.arange(indptr.size - 1),
                                              deg)))
                kw.update(memb=up(np.asarray(graph.indices)[order],
                                  torch.int32))
        return cls(
            **start,
            vdeg=up(np.stack([indptr[:-1], np.diff(indptr)], axis=1),
                    torch.int64),
            indices=up(graph.indices, torch.int32),
            nbr_prob=up(nbr_prob, torch.float32),
            nbr_alias=up(nbr_alias, torch.int32),
            uniform=uniform,
            walk_length=L, augmentation_step=aug,
            batch_size=int(batch_size), num_walk=num_walk, **kw)

    def to(self, device):
        """A copy of the sampler with its arrays on `device`."""
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if torch.is_tensor(getattr(self, f.name))}
        return dataclasses.replace(self, **moved)

    @staticmethod
    def _build_cuckoo(graph, max_bytes=None):
        """Host-build the [M, 4] cuckoo table over the directed CSR edges
        (native/sampler.cpp), M the smallest power of two >= Ed / 1.2,
        doubled up to twice on a failed insertion; None when the native
        library is unavailable or the table would exceed `max_bytes`
        (GRAPHVITE_CUCKOO_MAX_BYTES, default 2e9)."""
        from graphvite_tpu_torch import native

        if native.load() is None:
            return None
        if max_bytes is None:
            max_bytes = float(os.environ.get("GRAPHVITE_CUCKOO_MAX_BYTES",
                                             2e9))
        ed = int(np.asarray(graph.indices).size)
        if ed == 0:
            return None
        m = 1 << max(int(math.ceil(math.log2(max(ed / 1.2, 2)))), 1)
        us = np.repeat(np.arange(graph.indptr.size - 1),
                       np.diff(graph.indptr)).astype(np.int32)
        vs = np.ascontiguousarray(graph.indices, np.int32)
        for _ in range(3):
            if 16 * m > max_bytes:
                return None
            table = native.build_cuckoo(us, vs, m)
            if table is not None:
                return table
            m *= 2
        return None

    def arrays(self):
        out = (self.edge_prob, self.edge_alias, self.heads, self.tails,
               self.vdeg, self.indices, self.nbr_prob, self.nbr_alias)
        return out + (self.memb,) if self.biased else out

    def make_chain_fn(self, num_walk=None):
        return make_walk_chain_fn(self.uniform, self.walk_length,
                                  num_walk or self.num_walk,
                                  biased=self.biased, p=self.p, q=self.q,
                                  bs_iters=self.bs_iters,
                                  membership=self.membership,
                                  start_csr=self.start_csr)

    def make_sample_fn(self, batch_size: int):
        """fn(*arrays, generator=None, draws=None) -> the layout's sample:
        banded (chainT [W, L1], chainT, pmask [W, L1, T]; the banded step
        reads the ids once for both roles, mean(pmask) is the valid-pair
        fraction); position-major (heads [B/T], tails [B/T, T], mask
        [B/T, T] float32); pairs (heads [B], tails [B], mask [B] float32).
        `draws` are the chain's (make_walk_chain_fn)."""
        if batch_size != self.batch_size:
            raise ValueError("sampler was built for batch_size %d, not %d"
                             % (self.batch_size, batch_size))
        aug = self.augmentation_step
        bidir = self.bidir
        chain_fn = self.make_chain_fn()

        if self.banded:
            def sample(*arrays, generator=None, draws=None):
                chain, valid = chain_fn(*arrays, generator=generator,
                                        draws=draws)
                ct, pm = emit_walk_banded(chain, valid, aug, bidir=bidir)
                return ct, ct, pm
        elif self.position_major:
            bp = batch_size // self.num_tail

            def sample(*arrays, generator=None, draws=None):
                chain, valid = chain_fn(*arrays, generator=generator,
                                        draws=draws)
                h, t, m = emit_walk_positions(chain, valid, aug, bidir=bidir)
                return h[:bp], t[:bp], m[:bp].float()
        else:
            def sample(*arrays, generator=None, draws=None):
                chain, valid = chain_fn(*arrays, generator=generator,
                                        draws=draws)
                h, t, m = emit_walk_pairs(chain, valid, aug)
                return (h[:batch_size], t[:batch_size],
                        m[:batch_size].float())

        return sample

    def make_episode_sample_fn(self, batch_size: int, n_batches: int):
        """All `n_batches` batches' walks in ONE chain call of W * n lanes
        (the reference's GRAPHVITE_BULK_WALKS=1 opt-in, device_sampler.py
        make_episode_sample_fn there). fn(*arrays, generator=None,
        draws=None) -> the layout's sample with a leading [n] axis: batch
        g gets walks g*W .. (g+1)*W - 1, as the per-batch sampler would
        draw them. `draws` are the chain's for W * n lanes. Banded and
        pair layouts, node2vec's biased chain included; the
        position-major (multitail) sampler has no bulk emitter."""
        if batch_size != self.batch_size:
            raise ValueError("sampler was built for batch_size %d, not %d"
                             % (self.batch_size, batch_size))
        if self.position_major:
            raise NotImplementedError(
                "episode-bulk generation supports pair-major and banded "
                "layouts; the position-major (multitail) sampler has no "
                "bulk emitter")
        aug = self.augmentation_step
        W, n = self.num_walk, int(n_batches)
        chain_fn = self.make_chain_fn(W * n)

        if self.banded:
            bidir = self.bidir

            def sample(*arrays, generator=None, draws=None):
                chain, valid = chain_fn(*arrays, generator=generator,
                                        draws=draws)
                ct, pm = emit_walk_banded(chain, valid, aug, bidir=bidir)
                L1 = ct.shape[1]
                ct = ct.reshape(n, W, L1)
                return ct, ct, pm.reshape(n, W, L1, -1)
        else:
            def sample(*arrays, generator=None, draws=None):
                chain, valid = chain_fn(*arrays, generator=generator,
                                        draws=draws)
                # walk-major pairs: each batch takes its own W walks
                h, t, m = emit_walk_pairs(chain, valid, aug)
                return (h.reshape(n, -1)[:, :batch_size],
                        t.reshape(n, -1)[:, :batch_size],
                        m.reshape(n, -1)[:, :batch_size].float())

        # what a caller needs to make the draws: the chain and its lanes
        sample.chain_fn, sample.lanes = chain_fn, W * n
        return sample
