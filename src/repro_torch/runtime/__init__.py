"""Runtime of the training loop (port of `repro.runtime`: the
fault-tolerant loop and straggler detection; sharding, pipelining and
elastic resume come with the multi-card slice)."""
