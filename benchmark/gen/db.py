"""The probe DB of a configuration, from the seed: random canonical 30-mer
probes on random targets of a random tree (the builders' synthetic bact10
and mito DBs)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator for one use of the seed (any whole number,
    negative or past 64 bits included)."""
    return np.random.default_rng(np.random.SeedSequence([seed & (2**64 - 1), *stream]))


@dataclass
class ProbeDB:
    keys: np.ndarray  # uint64 [n], sorted, unique, canonical
    targets: np.ndarray  # int32 [n], in [2, num_targ)
    parent: np.ndarray  # int32 [num_targ]; 0 and 1 (the root) parent the root
    num_targ: int
    by_target: np.ndarray  # int32 [n]: indices of the keys, sorted by target (stable)
    target_start: np.ndarray  # int64 [num_targ + 1]: target t's keys are
    # by_target[target_start[t]:target_start[t + 1]]


def torch_generator(seed: int, stream: int, device):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed & (2**64 - 1), stream]).generate_state(
        1, np.uint64)[0]))
    return g


def revcomp_t(x):
    """:func:`dna.revcomp` on an int64 tensor of 60-bit keys (the byte
    reversal as a flip of the bytes; the last shift made logical)."""
    import torch

    x = x ^ ((1 << 60) - 1)
    m2, m4 = 0x3333333333333333, 0x0F0F0F0F0F0F0F0F
    x = ((x >> 2) & m2) | ((x & m2) << 2)
    x = ((x >> 4) & m4) | ((x & m4) << 4)
    x = x.contiguous().view(torch.uint8).view(-1, 8).flip(1).contiguous().view(torch.int64)
    return (x.view(-1) >> 4) & ((1 << 60) - 1)


def make_db(seed: int, n_probes: int, num_targ: int, device: str = "cpu") -> ProbeDB:
    """``n_probes`` distinct canonical keys drawn uniformly from the 2^60
    words (5% more drawn, then a random excess dropped, so the keys stay
    sorted), each on a target drawn uniformly from [2, num_targ), and a
    random recursive tree: target i >= 3 hangs under a node drawn from
    [1, i), target 2 under the root.  The keys and targets are drawn on
    ``device`` in a few large calls (the same seed gives the same DB on
    one kind of device)."""
    import torch

    rng = rng_for(seed, 0)
    parent = np.ones(num_targ, dtype=np.int32)
    if num_targ > 3:
        parent[3:] = rng.integers(1, np.arange(3, num_targ))
    g = torch_generator(seed, 0, device)
    raw = torch.randint(0, 1 << 60, (int(n_probes * 1.05) + 16,), generator=g, device=device,
                        dtype=torch.int64)
    keys = torch.unique(torch.minimum(raw, revcomp_t(raw)))
    del raw
    if len(keys) < n_probes:
        raise RuntimeError(f"drew {len(keys)} distinct keys, fewer than {n_probes}")
    keep = torch.ones(len(keys), dtype=torch.bool, device=device)
    keep[torch.randperm(len(keys), generator=g, device=device)[: len(keys) - n_probes]] = False
    keys = keys[keep]
    targets = torch.randint(2, num_targ, (n_probes,), generator=g, device=device,
                            dtype=torch.int32)
    by_target = torch.sort(targets, stable=True).indices.to(torch.int32)
    start = torch.zeros(num_targ + 1, dtype=torch.int64, device=device)
    start[1:] = torch.cumsum(torch.bincount(targets, minlength=num_targ), 0)
    return ProbeDB(keys.cpu().numpy().view(np.uint64), targets.cpu().numpy(), parent, num_targ,
                   by_target.cpu().numpy(), start.cpu().numpy())
