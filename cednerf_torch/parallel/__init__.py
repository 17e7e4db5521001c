from .mesh import (Mesh, all_gather_rows, all_reduce_grads, barrier,  # noqa: F401
                   global_sum, make_mesh, replicate, shard_batch)
