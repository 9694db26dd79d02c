"""Reference-order greedy parity mode (host, K=1).

The device encoder deliberately diverges from the reference's heap-driven
greedy loop (documented in encoder.py:45-58): live-array priorities, a
real 4th companion, seeded tie-breaks.  This module closes the one SURVEY
contract with no artifact - "K=1 reproduces the greedy semantics for the
pinned-parity mode" - by emulating the REFERENCE's exact scheduling
semantics on top of this repo's own cost model:

- a per-(frame, bank) priority heap whose entries can go stale (popped
  entries re-check the live priority array and are skipped only when it
  reached zero - matching reference transcoder/video.py:121-131, where an
  entry re-pushed with a residual leaves the old, higher-priority entry in
  the heap to be processed early);
- at most TWO companion offsets per opcode, the 4th slot padded with the
  primary offset (reference video.py:180-185);
- companions ranked by strict improvement (delta < 0) of the store against
  the live diff row, residuals re-pushed onto the MAIN heap (reference
  video.py:147-178);
- deterministic tie-breaks: with the reference's RNG pinned to zero
  (random.getrandbits/np.random.randint -> 0), heap order falls through
  the nonce to (page, offset) - reproduced here by heap tuples with a
  zero nonce field.

Cost-model equivalence (why op-for-op parity is even possible): the
reference scores a primary store by the accumulated update_priority of
its diff cell, a companion by compute_delta_page = dist(target-with-
content-stored, target) - diff_weights (reference screen.py:525-547,
video.py:275-301), and a companion's residual by byte_pair_difference on
the TARGET's packed data (video.py:160-172, screen.py:383-398).  Both of
the latter reduce to this repo's store-cost table evaluated on the target
lane windows - sc[page, offset, content] - because the edit distance only
depends on the masked window around the stored byte.  ops/distance.py
values equal the reference's npz tables (pinned by tests), so every
number the reference compares is available here exactly.

Used by bench_ab_reference.py --parity to quantify opcode-for-opcode
agreement against the actual reference encoder under pinned RNG.
"""

import heapq
from typing import List, Tuple

import numpy as np

from iivision_tpu.encoder_host import HostEncoder
from iivision_tpu.video_mode import VideoMode


class ReferenceOrderEncoder(HostEncoder):
    """Heap-scheduled K=1 greedy with the reference's staleness semantics."""

    def __init__(self, mode: VideoMode, dist):
        super().__init__(mode, dist, k=1, seed=None, j=1)
        self.heap: List[Tuple[int, int, int, int]] = []
        self.exhausted = False

    def start_chunk(self, tgt_lanes, bank: int) -> None:
        """(frame, bank) boundary: refresh diff + priorities, rebuild the
        heap (the reference rebuilds it on every encode_frame call:
        video.py:119, movie.py:94-102)."""
        self.recompute(tgt_lanes, bank)
        up = self.up[bank]
        entries = [(-int(up[p, o]), 0, int(p), int(o))
                   for p, o in zip(*np.nonzero(up))]
        heapq.heapify(entries)
        self.heap = entries
        self.exhausted = False

    def next_op(self, tgt_bytes, bank: int) -> Tuple[int, ...]:
        up = self.up[bank]
        dw = self.dw[bank]
        bank_bytes = self.banks[bank]
        while self.heap:
            _, _, pg, off0 = heapq.heappop(self.heap)
            if up[pg, off0] == 0:
                continue  # resolved while queued (reference video.py:128-131)
            content = int(tgt_bytes[pg, off0])
            up[pg, off0] = 0
            dw[pg, off0] = 0
            bank_bytes[pg, off0] = content

            # companions: strict-improvement candidates of this page,
            # best-first with ties to lowest offset (zero nonce)
            sc_row = self.sc[pg, :, content & (self.C - 1)]
            gain = dw[pg] - sc_row  # >0 iff the store improves the cell
            cands = [(-int(gain[o]), 0, int(o))
                     for o in np.nonzero(gain > 0)[0]]
            heapq.heapify(cands)
            offs = [off0]
            while cands and len(offs) < 3:
                _, _, o = heapq.heappop(cands)
                if up[pg, o] == 0:
                    continue
                resid = int(sc_row[o])
                up[pg, o] = resid
                bank_bytes[pg, o] = content
                if resid:
                    heapq.heappush(self.heap, (-resid, 0, pg, o))
                offs.append(o)
            while len(offs) < 4:
                offs.append(off0)  # reference pads slots with the primary
            return (pg + 32, content, offs[0], offs[1], offs[2], offs[3])
        # out of work: the reference's padding op (video.py:248-251)
        self.exhausted = True
        return (32, int(tgt_bytes[0, 0]), 0, 0, 0, 0)


def encode_movie_reference_order(dist, lanes_tgt, bytes_tgt, plan,
                                 mode: VideoMode) -> np.ndarray:
    """Run the planned movie in reference greedy order; (n_ops, 6) int32.

    Requires a K=1, J=1 plan (one opcode per scan step, chunk boundaries
    exactly at the reference's encode_frame refresh points)."""
    if plan.k != 1 or plan.j != 1:
        raise ValueError("reference-order parity requires a k=1, j=1 plan")
    enc = ReferenceOrderEncoder(mode, dist)
    lanes_tgt = np.asarray(lanes_tgt)
    bytes_tgt = np.asarray(bytes_tgt)
    out = []
    for s in range(len(plan.step_frame)):
        f = int(plan.step_frame[s])
        bank = int(plan.step_bank[s])
        if plan.step_recompute[s]:
            enc.start_chunk(lanes_tgt[f], bank)
        for _ in range(int(plan.step_nvalid[s])):
            out.append(enc.next_op(bytes_tgt[f, bank], bank))
    return np.asarray(out, dtype=np.int32)
