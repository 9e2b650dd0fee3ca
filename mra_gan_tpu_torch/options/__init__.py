"""Command-line flags of the port's drivers: the training driver's
(base_options, train_options) and the decode CLI's and daemon's
(test_options)."""
