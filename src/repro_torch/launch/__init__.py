"""Entry points: ``pipeline`` assembles the asynchronous RLVR and agentic
pipelines, ``train`` is the command-line entry point
(``python -m repro_torch.launch.train``)."""
