"""The latent attention's share of its roofline: the least time of the
attends the traced groups' inputs need (``benchlib/roofline_mla.py``: the
larger of the live latent rows' bytes over the memory rate and the visible
pairs' operations over the bf16 peak, from the program's
``attn.latent_rows`` and ``attn.latent_pairs`` counters) over the
device-stream ms of its ``model.latent_attention`` spans. The count is of
the work the inputs need, so it reads the same whatever computes the
attend."""

NAME = "latent_attn_roofline.ctxchat"
UNIT = "%"
LAYER = "kernels"
MOVES = "tpot_p95_ms"

from h100bench.benchlib import spans
from h100bench.benchlib.roofline_mla import WorkMLA


def read(obs):
    got, attn = spans.counts(), spans.device_ms().get("model.latent_attention")
    rows, pairs = got.get("attn.latent_rows"), got.get("attn.latent_pairs")
    if not rows or attn is None or not attn[1] or obs.get("config") is None:
        return None
    return 100.0 * WorkMLA(obs["config"]).latent_least_s(rows, pairs or 0) / (attn[1] / 1e3)
