"""dp4.train_tokens_per_s: train_tokens_per_s in the data-parallel cells, which report
dp4.train_tokens_per_s (summed over ranks) in place of train_tokens_per_s."""

from portbench.harness import metric_reader

read = metric_reader("train_tokens_per_s")
