"""Hand-written Hopper kernels of the port and their plain PyTorch
versions. Sources live in `../csrc/`; `build.py` compiles them with
nvcc for sm_90a at first use and loads them with ctypes."""


def kernel_counts() -> dict[str, int]:
    """This process's counts: each wrapper's kernel launches (`<name>`)
    and its calls that took the plain version (`<name>_plain`, a CPU
    tensor). Counts are per process: a router's replicas report theirs
    over the pipe."""
    from .bulk_events import bulk_events_fused
    from .decima_encoder import decima_node_encoder, decima_node_encoder_bwd
    from .rbg import rbg_random_bits, split_uniform
    from .threefry import threefry2x32

    out = {}
    for fn in (decima_node_encoder, decima_node_encoder_bwd, rbg_random_bits,
               threefry2x32, split_uniform, bulk_events_fused):
        out[fn.__name__] = fn.launches
        out[f"{fn.__name__}_plain"] = fn.plain_calls
    return out
