"""peak_mem_gib.static (layer: device; moves solve_edges_per_s): the
card's allocated memory at its peak over the window
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start), in GiB."""
from msfbench.harness.stats import peak_gib


def read(run):
    return peak_gib(run)
