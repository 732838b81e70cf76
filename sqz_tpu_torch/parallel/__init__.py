"""Block-parallel coding over a mesh of devices and processes: the port
of ``sqz_tpu/parallel`` (``mesh``, ``multihost``, ``shard``) on
``torch.distributed``, and its dry run (``dryrun``)."""
