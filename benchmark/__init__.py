"""The benchmark of the PyTorch port (``kmer_id_tpu_torch``) on one CUDA card.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see README.md.
Nothing in this package imports the JAX package, ``bench.py``,
``chip_smoke.py`` or ``tests/``; the reference (``reference/``) imports no
package of the repository.
"""
