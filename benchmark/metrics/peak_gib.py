"""The allocator's peak of device memory over set-up and window
(``torch.cuda.max_memory_allocated``, the programs' graph pools
included), in GiB."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30
