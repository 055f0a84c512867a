"""Work of the temporal self-attention's deformable attention call: the
same call as any multi-scale deformable attention forward (value (2B, V,
heads, D) for the queue of two maps a sample), so ``msda_fwd``'s formula."""

from benchmark.spec import load_file

_msda_fwd = load_file("work", "msda_fwd")


def work(call):
    return _msda_fwd.work(call)
