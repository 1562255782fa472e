"""Hand-written kernel launches of one replay (the engine's counts taken
at capture) per image: the kernels of ``mixdq_tpu_torch.ops``; the plain
PyTorch towers and VAE launch beside them uncounted."""


def read(r):
    if not r.launches:
        return None
    return sum(r.launches.values()) / r.batch
