#!/usr/bin/env python3
"""A numpy model of flash attention's bf16 (wgmma) tile schedule, written
before the kernels were built and kept beside them: it mirrors
``csrc/flash_attention_sm90.cuh``'s index arithmetic (``live_groups``,
``first_key``, ``last_key``, ``tiles_to``, ``kv_steps``, ``kv_work``,
``unseen_keys``, ``kv_plan``) and checks, over ragged S, causal and
windowed masks, groups and block shapes:

* every visible (query, key) pair is covered exactly once, by the forward /
  dQ blocks' warpgroups and by the dK/dV blocks' parts;
* a tile a warpgroup passes unread (its rows stop before the block's band
  ends, or its keys lie past the queries' diagonal) holds no visible pair;
* the ring turns: a producer and consumers that each wait for every stage's
  ``full`` barrier and arrive on its ``empty`` in order finish, and every
  parity wait refers to the phase in flight or the one just completed;
* the D = 256 dK/dV pair, whose first warpgroup issues the loads itself
  and hands P^T over through the xfull / xempty barriers, finishes too.

Then it prints the dK/dV plans (chunk, blocks along the work dimension,
most parts of a key block) at the shapes the card runs, for 132 SMs.

    python3 tools/flash_schedule_model.py

Plain numpy, no card; edit it with the kernels' arithmetic.
"""

import itertools

import numpy as np

T = 64

def cdiv(a, b): return -(-a // b)

def visible(q, k, causal, window):
    if causal and k > q: return False
    if window and q - k >= window: return False
    return True

def vis_matrix(S, causal, window):
    q = np.arange(S)[:, None]; k = np.arange(S)[None, :]
    m = np.ones((S, S), bool)
    if causal: m &= k <= q
    if window: m &= (q - k) < window
    return m

def live_groups(nwg, first, S): return min(nwg, cdiv(S - first, T))
def tiles_to(hi, lo): return cdiv(hi - lo, T)
def first_key(q0, window): return (max(0, q0 - window + 1) // T) * T if window else 0
def last_key(r0, rows, S, causal): return min(S, r0 + rows) if causal else S

def ring(n_items, stages, consumers_touch):
    """Simulate producer + consumers; consumers_touch[c] = ordered items c
    waits for and releases.  Checks: no deadlock, every wait's parity refers
    to the barrier's current or just-completed phase (no aliasing)."""
    full_done = [0] * stages      # completed phases of full[st]
    empty_cnt = [0] * stages      # arrivals in the current phase
    empty_done = [0] * stages
    ncons = len(consumers_touch)
    pos = [0] * ncons
    p = 0
    progress = True
    while progress:
        progress = False
        if p < n_items:
            st = p % stages
            if p < stages or empty_done[st] >= p // stages:
                assert full_done[st] == p // stages
                full_done[st] += 1; p += 1; progress = True
        for c in range(ncons):
            seq = consumers_touch[c]
            if pos[c] < len(seq):
                t = seq[pos[c]]; st = t % stages; ph = t // stages
                # try_wait.parity(ph & 1): true iff current phase parity != ph&1
                # i.e. full_done[st] % 2 != ph % 2 ... the wait is sound only if
                # full_done[st] in (ph, ph + 1)
                if full_done[st] % 2 != ph % 2:
                    assert full_done[st] == ph + 1, ("aliased wait", c, t, full_done[st])
                    # arrive on empty in the phase of item t
                    assert empty_done[st] == ph, ("arrival in wrong phase", c, t)
                    empty_cnt[st] += 1
                    if empty_cnt[st] == ncons:
                        empty_cnt[st] = 0; empty_done[st] += 1
                    pos[c] += 1; progress = True
    assert p == n_items, "producer stuck"
    assert all(pos[c] == len(consumers_touch[c]) for c in range(ncons)), "consumer stuck"

def fwd_like(S, causal, window, nwg, stages):
    """Forward / dQ: blocks of nwg warpgroups over query tiles."""
    vis = vis_matrix(S, causal, window)
    cover = np.zeros((S, S), int)
    for q0 in range(0, S, T * nwg):
        live = live_groups(nwg, q0, S)
        k_lo = first_key(q0, window)
        n_tiles = tiles_to(last_key(q0, T * live, S, causal), k_lo)
        touches = []
        for wg in range(live):
            r_lo = q0 + T * wg
            n_mine = tiles_to(last_key(r_lo, T, S, causal), k_lo)
            assert 1 <= n_mine <= n_tiles
            rows = slice(r_lo, min(S, r_lo + T))
            for t in range(n_mine):
                k0 = k_lo + T * t
                cover[rows, k0:min(S, k0 + T)] += 1
            # tiles passed unread hold no visible pair of this warpgroup
            for t in range(n_mine, n_tiles):
                k0 = k_lo + T * t
                assert not vis[rows, k0:min(S, k0 + T)].any()
            touches.append(list(range(n_mine)) + list(range(n_mine, n_tiles)))
        # keys before k_lo: invisible to the block
        assert not vis[q0:min(S, q0 + T * nwg), :k_lo].any()
        ring(n_tiles, stages, [t for t in touches for _ in range(4)])
    assert (cover[vis] == 1).all(), "a visible pair missed or doubled"

def kv_steps(k0, bn, S, G, causal, window):
    lo = k0 // T if causal else 0
    hi = min(S, k0 + bn - 1 + window) if window else S
    return G * (cdiv(hi, T) - lo), lo, cdiv(hi, T) - lo

def kv_plan(B, KV, G, S, bn, causal, window, want):
    total, most = 0, 1
    for k0 in range(0, S, bn):
        st = kv_steps(k0, bn, S, G, causal, window)[0]
        total += st; most = max(most, st)
    chunk = min(max(1, cdiv(total * KV * B, want)), most)
    blocks = sum(cdiv(kv_steps(k0, bn, S, G, causal, window)[0], chunk)
                 for k0 in range(0, S, bn))
    return chunk, blocks, cdiv(most, chunk)

def kv_work(x, bn, S, G, causal, window, chunk):
    k0 = 0
    while True:
        steps, lo, n = kv_steps(k0, bn, S, G, causal, window)
        parts = cdiv(steps, chunk)
        if x < parts:
            s0 = x * steps // parts
            return k0, lo, n, x, parts, s0, (x + 1) * steps // parts - s0
        x -= parts; k0 += bn

def unseen_keys(kw0, qq, causal, window):
    return (causal and qq + T - 1 < kw0) or (window and qq - (kw0 + T - 1) >= window)

def dkv(S, G, causal, window, nwg, stages, want, pair):
    bn = T if pair else T * nwg
    vis = vis_matrix(S, causal, window)
    chunk, blocks, max_parts = kv_plan(1, 1, G, S, bn, causal, window, want)
    cover = np.zeros((G, S, S), int)     # (head, query, key)
    parts_of = {}
    for x in range(blocks):
        k0, lo, n, part, parts, s0, n_steps = kv_work(x, bn, S, G, causal, window, chunk)
        assert n_steps >= 1 and parts <= max_parts
        parts_of.setdefault(k0, set()).add(part)
        live = 1 if pair else live_groups(nwg, k0, S)
        touches = []
        for wg in range(live):
            kw = k0 if pair else k0 + T * wg
            keys = slice(kw, min(S, kw + T))
            seq = []
            for i in range(n_steps):
                s = s0 + i; h = s // n; qq = (lo + s % n) * T
                qs = slice(qq, min(S, qq + T))
                if not pair and causal and unseen_keys(kw, qq, causal, window):
                    assert not vis[qs, keys].any(), "skipped a visible pair"
                else:
                    cover[h, qs, keys] += 1
                seq.append(i)
            touches.append(seq)
        ring(n_steps, stages, [t for t in touches for _ in range(4 * (2 if pair else 1))])
    for k0, ps in parts_of.items():
        assert ps == set(range(len(ps)))
    for h in range(G):
        assert (cover[h][vis] == 1).all(), "dK/dV pair missed or doubled"
        # the sum kernel's parts for each key equal the blocks' count
    return chunk, blocks, max_parts



def pair_protocol(n_steps, ST):
    done = {}          # barrier -> completed phases
    count = {}         # barrier -> arrivals in the current phase
    need = {**{('full', s): 1 for s in range(ST)}, **{('empty', s): 2 for s in range(ST)},
            'xfull': 1, 'xempty': 1}
    def arrive(bar):
        count[bar] = count.get(bar, 0) + 1
        if count[bar] == need[bar]:
            count[bar] = 0; done[bar] = done.get(bar, 0) + 1
    def ready(bar, phase):
        d = done.get(bar, 0)
        if d % 2 != phase % 2:           # try_wait.parity(phase & 1) returns true
            assert d == phase + 1, ("aliased wait", bar, phase, d)
            return True
        return False
    def load(i):   # TMA: completes at once (the worst order for the checks)
        arrive(('full', i % ST))
    A, B = [], []
    for i in range(min(ST, n_steps)):
        A.append(('load', i))
    for i in range(n_steps):
        st = i % ST
        A.append(('wait', ('full', st), i // ST))
        if i >= 1 and i - 1 + ST < n_steps:
            A.append(('wait', ('empty', (i - 1) % ST), (i - 1) // ST))
            A.append(('load', i - 1 + ST))
        if i > 0:
            A.append(('wait', 'xempty', i - 1))
        A.append(('arrive', 'xfull'))
        A.append(('arrive', ('empty', st)))
        B.append(('wait', ('full', st), i // ST))
        B.append(('wait', 'xfull', i))
        B.append(('arrive', 'xempty'))
        B.append(('arrive', ('empty', st)))
    pos = [0, 0]
    procs = [A, B]
    while True:
        moved = False
        for k in (0, 1):
            while pos[k] < len(procs[k]):
                op = procs[k][pos[k]]
                if op[0] == 'wait' and not ready(op[1], op[2]):
                    break
                if op[0] == 'load':
                    load(op[1])
                elif op[0] == 'arrive':
                    arrive(op[1])
                pos[k] += 1; moved = True
        if not moved:
            break
    assert pos == [len(A), len(B)], ("deadlock", n_steps, ST, pos)


def main():
    cases = 0
    for S in (1, 2, 37, 63, 64, 65, 100, 128, 130, 200, 256, 300, 512, 700):
        for causal, window in ((True, None), (False, None), (True, 48), (True, 128), (False, 9), (True, 2048)):
            for nwg, stages in ((3, 4), (2, 3), (2, 2), (1, 2)):
                fwd_like(S, causal, window, nwg, stages)
            for G in (1, 2, 6):
                for want in (1, 7, 132, 264):
                    dkv(S, G, causal, window, 2, 4, want, False)
                    dkv(S, G, causal, window, 2, 2, want, True)
            cases += 1
    print("ok", cases, "shape/mask cases")
    # the plans at the shapes the card runs (132 SMs)
    for label, (B, H, KV, S, D, causal, window) in {
            "trainer": (8, 16, 8, 512, 128, True, None),
            "paligemma": (8, 8, 1, 512, 256, True, None),
            "seamless_dec": (16, 16, 16, 256, 64, True, None),
            "seamless_enc": (16, 16, 16, 1024, 64, False, None),
            "recurrentgemma": (1, 16, 1, 2100, 256, True, 2048),
            "odd_noncausal": (2, 16, 4, 300, 64, False, None)}.items():
        bn = 64 if D >= 128 else 128   # the pair kernel from D = 128: one key tile a block
        print(label, "chunk, blocks, max_parts =",
              kv_plan(B, KV, H // KV, S, bn, causal, window, 132), "x KV*B =", KV * B)
    for n, st in itertools.product(range(1, 40), (2, 3, 4)):
        pair_protocol(n, st)
    print("pair protocol ok")


if __name__ == "__main__":
    main()
