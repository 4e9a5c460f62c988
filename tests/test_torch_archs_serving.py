"""``ContinuousBatcher(paged=True)`` on gemma2's and phi-3-vision's
``smoke()``: greedy tokens bitwise the reference batcher's; an embeds
config has no token path (helpers: ``tests/test_torch_archs.py``)."""
import numpy as np
import pytest

from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_archs import _models, jserve, tserve


# ---------------------------------------------------------------------------
# serving gemma2 and phi-3-vision smoke()
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["gemma2-27b", "phi-3-vision-4.2b"])
@pytest.mark.parametrize("method", ["vanilla", "clipped"])
def test_paged_batcher_tokens_equal_reference(arch, method):
    """Four greedy requests over two slots (max_len 64, block 8, budget
    16): gemma2's local layers keep a ring of 8 slots that the 30-token
    prompt wraps; phi-3-vision serves text prompts through its token
    embeddings."""
    jc, jp, tc, tp = _models(arch, method)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, tc.vocab_size, size=n).astype(np.int32) for n in (30, 5, 19, 9)]
    max_new = [12, 3, 8, 6]

    def serve(pkg, params, cfg, **kw):
        b = pkg.ContinuousBatcher(params, cfg, batch_size=2, max_len=64, block_size=8,
                                  token_budget=16, paged=True, **kw)
        for u, p in enumerate(prompts):
            b.submit(pkg.Request(uid=u, prompt=p, max_new_tokens=max_new[u]))
        b.run()
        assert not b.failed
        return {r.uid: r.output.tolist() for r in b.done}, b

    ref, _ = serve(jserve, jp, jc)
    got, b = serve(tserve, tp, tc, device="cpu", debug_audit=True)
    assert got == ref
    assert [len(got[u]) for u in range(4)] == max_new
    b.audit()
    assert b.allocator.available == b.num_blocks


def test_batcher_refuses_an_embeds_config():
    _, _, tc, tp = _models("hubert-xlarge", "vanilla")
    with pytest.raises(ValueError, match="no token path"):
        tserve.ContinuousBatcher(tp, tc, batch_size=2, max_len=64, device="cpu")
