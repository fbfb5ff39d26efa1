"""The port's data pipeline (``repro_torch.data.pipeline``, numpy only)
against the reference's: the same epoch shuffles, token streams and
loader batches, bit for bit."""
import numpy as np
import pytest

from repro.data import pipeline as RP
from repro_torch.data import pipeline as TP


@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 3), (7, 1)])
def test_epoch_bmmc_and_tokens_match_the_reference(seed, epoch):
    rc = RP.DataConfig(n_samples_log2=10, seq_len=16, vocab_size=97,
                       seed=seed)
    tc = TP.DataConfig(n_samples_log2=10, seq_len=16, vocab_size=97,
                       seed=seed)
    rb, tb = RP.epoch_bmmc(rc, epoch), TP.epoch_bmmc(tc, epoch)
    assert (tb.rows, tb.c) == (rb.rows, rb.c)
    for sid in (0, 5, 1023):
        np.testing.assert_array_equal(TP.sample_tokens(tc, sid),
                                      RP.sample_tokens(rc, sid))


@pytest.mark.parametrize("n_hosts,host_id", [(1, 0), (2, 1)])
def test_sharded_loader_batches_match_the_reference(n_hosts, host_id):
    kw = dict(n_samples_log2=5, seq_len=8, vocab_size=31, seed=3)
    rl = RP.ShardedLoader(RP.DataConfig(**kw), batch_size=4,
                          host_id=host_id, n_hosts=n_hosts)
    tl = TP.ShardedLoader(TP.DataConfig(**kw), batch_size=4,
                          host_id=host_id, n_hosts=n_hosts)
    for _ in range(10):        # past the end of the shard: the next epoch
        rb, tb = next(rl), next(tl)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[key], rb[key])
        assert tl.state() == rl.state()
    resumed = TP.ShardedLoader(TP.DataConfig(**kw), batch_size=4,
                               host_id=host_id, n_hosts=n_hosts)
    resumed.restore(tl.state())
    np.testing.assert_array_equal(next(resumed)["tokens"],
                                  next(rl)["tokens"])
