#!/usr/bin/env python3
"""compact.cu's device time by payload form, on one card.

    python3 tools/compact_forms.py

At every chip_smoke KERNEL_SHAPES row, density 0.03, times
``compact_ranks_cuda`` (CUDA-graph replay, chip_smoke.device_ms) with the
payload planes in the form the row's caller passes (``form``), the
position plane materialised per row at the caller's width (``pos_rows``),
every payload plane materialised to [B, C] (``full``), and the caller's
form without the extra planes (``no_extras``); beside them ``floor``, one
``fill_`` of a [B, max_hits] int32 plane, the time a launch takes at that
output size.  Each form is first held bit-equal to compact_ranks_plain.
Prints one JSON line per shape (microseconds) after the card's name and
power limit.  Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    from kmer_id_tpu_torch.ops.compact import compact_ranks_cuda, compact_ranks_plain

    if not torch.cuda.is_available():
        print("compact_forms: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    rng = np.random.default_rng(cs.SEED)
    for name, b, c, mh, form, n_ex in cs.KERNEL_SHAPES:
        cand, valid, pos, ex, r = cs.kernel_inputs(rng, b, c, cs.REPORT_DENSITY, form, "cuda")
        ex = ex[:n_ex]

        def full(x):
            return (x.repeat_interleave(r, dim=1) if x.shape[1] != c else x).expand(b, c).contiguous()

        forms = {"form": (pos, ex, r),
                 "pos_rows": (pos.expand(b, pos.shape[1]).contiguous(), ex, r),
                 "full": (full(pos), tuple(map(full, ex)), 1),
                 "no_extras": (pos, (), r)}
        out = {}
        for key, (p, e, rr) in forms.items():
            got = compact_ranks_cuda(cand, valid, p, mh, extras=e, r=rr)
            want = compact_ranks_plain(cand, valid, p, mh, extras=e, r=rr)
            torch.cuda.synchronize()
            if cs.compact_mismatch(got, want, len(e))[0]:
                raise AssertionError(f"compact.cu != plain at {name} {key}")
            out[key] = 1e3 * cs.device_ms(
                lambda: compact_ranks_cuda(cand, valid, p, mh, extras=e, r=rr))
        plane = torch.empty((b, mh), dtype=torch.int32, device="cuda")
        out["floor"] = 1e3 * cs.device_ms(lambda: plane.fill_(0))
        print(json.dumps({"shape": name, "rows": b, "cols": c, "max_hits": mh,
                          "caller_form": form, "us": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
