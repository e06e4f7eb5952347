"""dp4.train_optimizer_ms: train_optimizer_ms in the data-parallel cells, which report
dp4.train_tokens_per_s (summed over ranks) in place of train_tokens_per_s."""

from portbench.harness import metric_reader

read = metric_reader("train_optimizer_ms")
