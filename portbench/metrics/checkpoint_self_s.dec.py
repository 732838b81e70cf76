"""checkpoint_self_s.dec: the checkpoint layer's own time in a load (the
file read, the metadata, each leaf's undelta, unshuffle and view),
seconds a call: ``load_pytree``'s wall time less the stages of its
``stats=`` dict (``pack_s``, ``upload_s``, ``kernel_s``, ``cell_s``,
``general_s``, ``host_s`` of the resident restore)."""

from portbench.readers import mean_self


def read(t):
    return mean_self(t)
