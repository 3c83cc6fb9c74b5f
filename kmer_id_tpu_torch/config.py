"""Configuration for the classifier/builder pipelines.

One dataclass covers what the reference spreads across compile-time constants
and per-variant CLI flags (SURVEY.md §5 config row): the three classifier
variants become presets —

* ``nx``  — bacterial batch mode (``newkmer_10nx.cpp``): hard-coded bact10 DB
  paths, directory scan for ``*_R1_tr.fastq.gz`` pairs, num_targ fixed 5982.
* ``vf6`` — generalized job mode (``kmer_read_vf6.cpp``): ``-name/-fadir/
  -jname/-target`` flags, U→T mapping, per-target read capture.
* ``m3``  — mitochondrial single-sample mode (``kmer_read_m3.cpp``):
  ``-wdir/-f1/-f2`` flags.

Copy of ``kmer_id_tpu/config.py``; ``BuildConfig`` without the two fields
nothing reads (``max_rep``: db/build.py's ``MAXREP``; ``exact_counts``).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ClassifyConfig:
    variant: str = "vf6"  # nx | vf6 | m3
    u_is_t: bool = True  # vf6/m3 map U/u to T; nx does not
    num_targ: int | None = None  # None: derive from data.txt (max target + 1)
    savenum: int = 12  # saved reads per target (newkmer_10nx.cpp:48)
    save_target: int = 0  # vf6 -target capture (kmer_read_vf6.cpp:617-620)
    batch_size: int = 1024
    max_len: int = 512
    bucket_bits: int | None = None  # None: auto from DB size
    engine: str = "fp"  # fp (fingerprint, production) | legacy (sorted/cuckoo)

    # alignment verification (disabled in all shipped reference configs;
    # newkmer_10nx.cpp:27)
    minalign: int = 0
    fadir: str = ""  # genome dir for verification (accession.fasta.gz)
    accessions: list | None = None  # org index -> accession

    # sharding
    mesh_shape: tuple = ()  # e.g. (("data", 4), ("db", 2)); empty = single device
    db_mode: str = "replicated"  # replicated | sharded

    @classmethod
    def preset(cls, variant: str, **overrides) -> "ClassifyConfig":
        base = {
            "nx": dict(variant="nx", u_is_t=False, num_targ=5982),
            "vf6": dict(variant="vf6", u_is_t=True),
            "m3": dict(variant="m3", u_is_t=True),
        }[variant]
        base.update(overrides)
        return cls(**base)


@dataclass
class BuildConfig:
    """Probe-builder parameters (kmer_build_vf6.cpp constants)."""

    max_probes_per_target: int = 100000  # MAXPROBES, kmer_build_vf6.cpp:41
    min_entropy: float = 0.80  # :543
    max_homopolymer: int = 11  # :524
