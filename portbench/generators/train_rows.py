"""Training rows: the root bench's Gato mixture, parametrised by a traffic
file.  Row i of a pool is of kind row_kinds[i % len(row_kinds)]:

* text: `text_len` random BPE ids (one timestep, then the separator);
* continuous: `timesteps` of `obs_dim` N(0, 1) observations and `act_dim`
  tanh(N(0, 1)) actions;
* image: `timesteps` of height x width x 3 random pixels and one discrete
  action of `actions`.

`pools` pools are drawn from the seed (pool p from SeedSequence([seed, p]);
over ranks, rank r > 0 draws its rows from SeedSequence([seed, p, r])), and
step n trains on pool n % pools: every seed gives the same sizes."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def kinds(t: dict, rows: int) -> List[str]:
    return [t["row_kinds"][i % len(t["row_kinds"])] for i in range(rows)]


def patches_per_image(t: dict, patch: int) -> int:
    im = t["image"]
    return (im["height"] // patch) * (im["width"] // patch)


def budgets(t: dict, rows: int, patch: int) -> Dict[str, int]:
    """The patch pool and the gathered-target budget of a batch, in 256s:
    every image patch; every text id and action a target at most."""
    ks = kinds(t, rows)
    up = lambda n: -(-n // 256) * 256  # noqa: E731
    n_img = ks.count("image") * t["image"]["timesteps"]
    targets = (ks.count("text") * t["text_len"]
               + ks.count("continuous") * t["continuous"]["timesteps"] * t["continuous"]["act_dim"]
               + n_img)
    return {"patch_budget": up(n_img * patches_per_image(t, patch)), "target_budget": up(targets)}


def pool(t: dict, text_tokens: int, rows: int, seed: int, index: int,
         rank: int = 0) -> List[dict]:
    rng = np.random.default_rng([int(seed), int(index)] + ([int(rank)] if rank else []))
    out = []
    for k in kinds(t, rows):
        if k == "text":
            out.append({"text": rng.integers(1, text_tokens, t["text_len"]).astype(np.int32)})
        elif k == "continuous":
            c = t["continuous"]
            out.append({
                "continuous_obs": rng.standard_normal((c["timesteps"], c["obs_dim"]),
                                                      dtype=np.float32),
                "continuous_actions": np.tanh(rng.standard_normal(
                    (c["timesteps"], c["act_dim"]), dtype=np.float32)),
            })
        elif k == "image":
            im = t["image"]
            out.append({
                "images": rng.integers(0, 256, (im["timesteps"], im["height"], im["width"], 3),
                                       dtype=np.uint8),
                "discrete_actions": rng.integers(0, im["actions"], im["timesteps"]).astype(np.int32),
            })
        else:
            raise ValueError(f"row kind {k!r}")
    return out


def pools(t: dict, text_tokens: int, rows: int, seed: int, rank: int = 0) -> List[List[dict]]:
    return [pool(t, text_tokens, rows, seed, p, rank) for p in range(t["pools"])]
