"""Task interface (counterpart of neko_tpu/tasks/base.py): tasks produce
raw example dicts (the packer turns them into device batches) and evaluate
a model through a `Generator`."""

from __future__ import annotations

from typing import Dict, List

from neko_tpu_torch.utils import host_state as hs


class Task:
    name: str = "task"

    def sample_batch(self, batch_size: int, **kwargs) -> List[Dict]:
        raise NotImplementedError

    def evaluate(self, generator, **kwargs) -> Dict[str, float]:
        raise NotImplementedError

    # The training-sampling RNG (`self.rng`) is part of the checkpointed
    # host stream state (utils/host_state.py); evaluation draws from a
    # separate `eval_rng`, so in-loop evaluation never perturbs it.
    def host_state(self) -> Dict:
        state: Dict = {}
        if getattr(self, "rng", None) is not None:
            state["rng"] = hs.rng_state(self.rng)
        return state

    def load_host_state(self, state: Dict) -> None:
        if "rng" in state and getattr(self, "rng", None) is not None:
            hs.set_rng_state(self.rng, state["rng"])
