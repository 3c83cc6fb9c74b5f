"""The sharded engines on a (data x db) grid of torch.distributed ranks."""

from kmer_id_tpu_torch.parallel.fpsharded import ShardedFpClassifier
from kmer_id_tpu_torch.parallel.mesh import Grid, make_mesh
from kmer_id_tpu_torch.parallel.sharded import ShardedClassifier

__all__ = ["Grid", "ShardedClassifier", "ShardedFpClassifier", "make_mesh"]
