"""Data and tensor parallelism over ``torch.distributed``: the (data, model) mesh,
the collectives built on ``all_reduce``, and the launcher of a world of ranks."""
