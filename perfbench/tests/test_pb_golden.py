"""The same seed gives the same bits: the seeded weights and the
reference's logits of the two smoke configurations, and the parameter
lists of both cells' configurations at published width, against
sha256 digests recorded before the layout moved into the reference
modules (``perfbench/lib/describe.py``).  Thread counts 1, 2 and 4 gave
the same digests."""
import hashlib
import json
from pathlib import Path

import pytest
import torch

from perfbench.lib import describe
from perfbench.lib import weights as wts

HERE = Path(__file__).resolve().parent
SEED = 2 ** 31 + 11

SMOKE = {
    "smoke-dense": ("8f0247fc3251f71411ea7694907647805883cc54f6082f9b490ec29ad7423df3",
                    "7a4084c7b33101616d248b768aa6575ce6b5de9fdd57a61d2f58e686ad424679"),
    "smoke-moe": ("8581ce0524266ec1bae6012235475931ad8176790b7cb8f9e105d5c44a30e494",
                  "ae5558a9dbf5cad6d000a30304dfb52e6ebb3ca8d5ce17138126d59f3fbb7453"),
}
PUBLISHED = {
    "stablelm-3b": (356, "c0522cd6d7d86bd164b72c127cf35d1b751127c9813345ce48415bd799317df2"),
    "granite-moe-3b-a800m": (322, "978243976c92d5fb40959d0a6386a14d429ce644cf10f6586ab53d06d838410b"),
}


def _bytes(t: torch.Tensor) -> bytes:
    return t.detach().contiguous().view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("conf", sorted(SMOKE))
def test_weights_and_logits_keep_their_bits(conf):
    f = json.loads((HERE / "data" / f"{conf}.json").read_text())
    ref, m = describe.load(f), f["model"]
    w = wts.make(ref, m, SEED, "cpu")
    h = hashlib.sha256()
    for name, _, _ in ref.specs(m):
        h.update(name.encode())
        h.update(_bytes(w[name]))
    z = ref.dims(m)
    seq = (torch.arange(40) * 131 + 7) % z["V"]
    lg = ref.logits(z, lambda n: w[n].float(), seq, torch.arange(40))
    assert (h.hexdigest(), hashlib.sha256(_bytes(lg)).hexdigest()) == SMOKE[conf]


@pytest.mark.parametrize("conf", sorted(PUBLISHED))
def test_published_parameter_lists_unchanged(conf):
    f = json.loads((HERE.parent / "configs" / f"{conf}.json").read_text())
    sp = [[n, list(s), k] for n, s, k in describe.load(f).specs(f["model"])]
    digest = hashlib.sha256(json.dumps(sp).encode()).hexdigest()
    assert (len(sp), digest) == PUBLISHED[conf]
