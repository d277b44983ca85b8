"""replay_share (layer: plans / planned replay): the share of the window
spent in the gateway's batched planned replay (``execute_plan_batched``,
its verifier included)."""
from msfbench.harness.stats import span_share

SITES = ("repro_torch.serve.msf_gateway:execute_plan_batched",)


def install(run):
    run.spans.wrap("replay", SITES)


def read(run):
    return span_share(run, "replay")
