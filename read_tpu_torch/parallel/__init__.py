"""Multi-device training: a ``('data', 'points')`` mesh of processes
(:mod:`read_tpu_torch.parallel.sharded`) and their start
(:mod:`read_tpu_torch.parallel.launch`)."""
