from .mesh import (all_reduce_mean, cli_devices, default_backend,
                   distributed, free_port, global_rank, initialize_multihost,
                   local_devices, process_count, process_index,
                   select_devices, shard_batch, unwrap, wrap_ddp)
