"""checkpoint_self_s.enc: the checkpoint layer's own time in a save
(``utils/checkpoint.py``: flatten, byte view, shuffle, delta, the
container's packing, the metadata, the write), seconds a call:
``save_pytree``'s wall time less the stages of its ``stats=`` dict
(``parse_s``, ``kernel_s``, ``fetch_s`` of the resident encoder)."""

from portbench.readers import mean_self


def read(t):
    return mean_self(t)
