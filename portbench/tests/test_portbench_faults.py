"""A run with its timed path broken underneath comes out not correct: the
harness's look for a chip skipped, everything else as a run drives it, at a
tiny size on the CPU, against the cell's own limits."""

from portbench.tests import tiny


def test_a_step_that_leaves_the_state_unchanged(monkeypatch):
    from neko_tpu_torch.training.train_state import TrainContext

    def unchanged(self, state):
        state.step += 1

    monkeypatch.setattr(TrainContext, "apply_gradients", unchanged)
    run = tiny.run_train()
    assert not run.correct()
    assert run.numbers["change_gap"] == 1.0


def test_half_of_the_batch_left_out(monkeypatch):
    from neko_tpu_torch.training.train_state import TrainContext

    step = TrainContext.train_step

    def half(self, state, batch):
        B = batch.tokens.shape[0]
        lp = batch.loss_pos.clone()
        lp[lp[:, 0] >= B // 2, 0] = B  # padding entries: the mean over the rest
        batch.loss_pos = lp
        return step(self, state, batch)

    monkeypatch.setattr(TrainContext, "train_step", half)
    run = tiny.run_train()
    assert not run.correct(), run.checks()


def test_a_served_token_altered_where_it_is_produced(monkeypatch):
    from neko_tpu_torch.inference.generator import Generator

    chunk = Generator.engine_chunk

    def altered(self, state, **kw):
        toks, state = chunk(self, state, **kw)
        toks = (toks + 1 - kw["start"]) % (kw["end"] + 1 - kw["start"]) + kw["start"]
        return toks, state

    monkeypatch.setattr(Generator, "engine_chunk", altered)
    run = tiny.run_serve()
    assert not run.correct(), run.checks()
