"""serve_prefill_useful_share: the continuous engine's counters over the
window: the admitted prompts' packed tokens over the tokens the admission
prefills ran (rows x the padded row length), in percent."""


def read(run):
    r = run.readings
    if not r.get("serve"):
        return None
    s0, s1 = r["stats"]
    if "prefill_tokens" not in s1:
        return None
    prefilled = s1["prefill_tokens"] - s0["prefill_tokens"]
    if prefilled <= 0:
        return None
    return 100.0 * (s1["prompt_tokens"] - s0["prompt_tokens"]) / prefilled
