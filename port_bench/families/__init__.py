"""One module a model family: how the benchmark builds the port's model and
objective for a configuration of that family, where its GDN sites are, and
its FLOPs. Its plain reference is ``port_bench/reference/<family>.py``."""
