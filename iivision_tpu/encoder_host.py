"""Host (numpy) oracle for the device encoder scan.

Implements exactly the algorithm of encoder.py's `lax.scan` step, scalar and
readable, for differential testing: with zero nonces the two must emit
identical opcode streams.  Uses the same distance model (ops/distance.py)
evaluated with numpy.

See encoder.py's module docstring for the documented divergences from the
reference's heapq greedy loop; they are shared by both implementations.
"""

from typing import List, Optional, Tuple

import numpy as np

from iivision_tpu import screen
from iivision_tpu.ops import distance
from iivision_tpu.video_mode import VideoMode


class HostEncoder:
    """Scalar mirror of the device encode scan."""

    def __init__(self, mode: VideoMode, dist, k: int = 8,
                 seed: Optional[int] = None, j: int = 1,
                 joint: bool = False):
        self.mode = mode
        self.joint = joint
        self.spec = screen.spec_for_mode(mode)
        self.store_cost = np.asarray(dist.store_cost)
        self.sub = np.asarray(dist.sub, dtype=np.float64)
        self.k = k
        self.j = j
        self.n_banks = 2 if mode == VideoMode.DHGR else 1
        self.C = distance.n_contents(mode)
        self.banks = np.zeros((self.n_banks, 32, 256), np.int32)
        self.up = np.zeros((self.n_banks, 32, 256), np.int32)
        self.dw = np.zeros((self.n_banks, 32, 256), np.int32)
        # the active bank's store-cost slab sc[page, offset, content],
        # rebuilt at every chunk-start recompute (mirrors the scan state)
        self.sc = np.zeros((32, 256, self.C), np.int32)
        self.not_hole = (~screen.SCREEN_HOLES).astype(np.int32)
        self.rng = np.random.RandomState(seed) if seed is not None else None

    def _cur_lanes(self):
        if self.mode == VideoMode.DHGR:
            return screen.dhgr_masked_lanes(self.banks[0], self.banks[1])
        return screen.hgr_masked_lanes(self.banks[0])

    def _bank_lanes(self, bank) -> Tuple[int, int]:
        if self.mode == VideoMode.DHGR:
            return self.spec.bank_lanes(bank == 1)
        return self.spec.bank_lanes(False)

    def _nonce(self, shape):
        if self.rng is None:
            return np.zeros(shape, np.float32)
        return self.rng.uniform(size=shape).astype(np.float32)

    def recompute(self, tgt_lanes, bank: int):
        """Chunk-start refresh: DP diff of the active bank + its store-cost
        slab sc[page, offset, content] (mirrors the scan's do_recompute)."""
        cur = self._cur_lanes()
        ds = [np.asarray(distance.dist_lane_pairs(
            cur[:, :, l], tgt_lanes[:, :, l], self.mode, l, self.sub))
            for l in range(int(self.spec.N_LANES))]
        le, lo = self._bank_lanes(bank)
        d = screen.interleave_bank_lanes(ds[le], ds[lo])
        d = d.astype(np.int32) * self.not_hole
        up = self.up[bank]
        self.up[bank] = np.where(d == 0, 0, up) + d
        self.dw[bank] = d
        sc16 = self.store_cost.astype(np.int16)
        se = sc16[le][tgt_lanes[:, :, le]]  # (32, 128, C)
        so = sc16[lo][tgt_lanes[:, :, lo]]
        self.sc = np.stack([se, so], axis=2).reshape(
            32, 256, self.C).astype(np.int32)

    def step(self, tgt_bytes, frame: int, bank: int,
             nvalid: int) -> List[Tuple]:
        up = self.up[bank]
        dw = self.dw[bank]
        bank_bytes = self.banks[bank]

        page_max = up.max(axis=1)
        score = page_max.astype(np.float32) * 256.0 + self._nonce(32) * 255.0
        pages = np.argsort(-score, kind="stable")[:self.k]
        nonce_o = self._nonce((self.j, self.k, 256))

        ops = []
        for idx in range(nvalid):
            # sub-op-major order: all selected pages' first ops, then their
            # second ops, ... (mirrors the scan's emit order); each sub-op
            # sees earlier sub-ops' updates on the same page
            jj, slot = divmod(idx, self.k)
            pg = int(pages[slot])
            if up[pg].max() <= 0:
                ops.append((32, int(tgt_bytes[0, 0]), 0, 0, 0, 0))
                continue
            off_score = up[pg].astype(np.float32) * 256.0 \
                + nonce_o[jj, slot] * 255.0
            off0 = int(np.argmax(off_score))
            if self.joint:
                # joint content (mirrors the scan's joint branch exactly):
                # argmax over all C content codes of [gain at the fixed
                # primary offset + 3 best positive companion gains].  All
                # terms are integers < 2^18, exact in f32, so the two
                # implementations stay bit-equal.
                block = self.sc[pg].astype(np.float32)  # (256, C)
                score_all = dw[pg].astype(np.float32)[:, None] - block
                prim = score_all[off0].copy()  # (C,)
                eligj = (up[pg] > 0) & (np.arange(256) != off0)
                slj = np.where(eligj[:, None] & (score_all > 0.0),
                               score_all, 0.0).astype(np.float32)
                comp = np.zeros(self.C, np.float32)
                for _ in range(3):
                    o = np.argmax(slj, axis=0)  # (C,)
                    vals = slj[o, np.arange(self.C)]
                    comp += vals
                    slj[o, np.arange(self.C)] = 0.0
                content = int(np.argmax(prim + comp))
            else:
                content = int(tgt_bytes[pg, off0])

            # companions: rank all offsets of the page against the LIVE
            # diff (mirrors the scan's slab contraction + 3 argmaxes)
            # cost index masks the DHGR palette bit (reference
            # video.py:135-137), matching the scan's slab row mask; the
            # emitted byte stays raw
            sc_row = self.sc[pg, :, content & (self.C - 1)]  # (256,)
            cscore = dw[pg] - sc_row
            elig = (up[pg] > 0) & (cscore > 0) \
                & (np.arange(256) != off0)
            s = np.where(elig, cscore.astype(np.float32), -1.0)
            offs = [off0]
            for _ in range(3):  # best three, ties to lowest offset
                o = int(np.argmax(s))
                if s[o] <= 0.0:
                    break
                offs.append(o)
                up[pg, o] = int(sc_row[o])
                bank_bytes[pg, o] = content
                s[o] = -1.0
            while len(offs) < 4:
                offs.append(off0)
            bank_bytes[pg, off0] = content
            if self.joint:
                # mirror the scan's joint rule: the primary keeps its
                # residual error (companion semantics) instead of being
                # declared done - joint may have stored a non-target byte
                r = int(sc_row[off0])
                up[pg, off0] = r
                dw[pg, off0] = r
            else:
                up[pg, off0] = 0
                dw[pg, off0] = 0
            ops.append((pg + 32, content, offs[0], offs[1], offs[2], offs[3]))
        return ops


def encode_movie_host(dist, lanes_tgt, bytes_tgt, plan, mode: VideoMode,
                      seed: Optional[int] = None,
                      joint: bool = False) -> np.ndarray:
    """Run the full planned movie on host; returns (n_ops, 6) int32."""
    enc = HostEncoder(mode, dist, k=plan.k, seed=seed, j=plan.j,
                      joint=joint)
    lanes_tgt = np.asarray(lanes_tgt)
    bytes_tgt = np.asarray(bytes_tgt)
    out = []
    for s in range(len(plan.step_frame)):
        f = int(plan.step_frame[s])
        bank = int(plan.step_bank[s])
        if plan.step_recompute[s]:
            enc.recompute(lanes_tgt[f], bank)
        out.extend(enc.step(bytes_tgt[f, bank], f, bank,
                            int(plan.step_nvalid[s])))
    return np.asarray(out, dtype=np.int32)
