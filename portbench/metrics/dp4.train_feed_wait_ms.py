"""dp4.train_feed_wait_ms: train_feed_wait_ms in the data-parallel cells, which report
dp4.train_tokens_per_s (summed over ranks) in place of train_tokens_per_s."""

from portbench.harness import metric_reader

read = metric_reader("train_feed_wait_ms")
