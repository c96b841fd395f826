"""The one way the port refuses a setting outside its slices: a
``NotImplementedError`` naming the ROADMAP.md item that will bring it."""


def not_ported(what: str, item: str):
    """Raise for ``what``; ``item`` names its ROADMAP.md queue and entry
    (e.g. "queue 1: training step (dataloader)")."""
    raise NotImplementedError(
        f"{what} is not ported to deepspeed_tpu_torch yet (ROADMAP.md {item})")
