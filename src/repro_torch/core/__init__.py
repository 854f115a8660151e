"""The heSRPT scheduler in PyTorch: ranking, policies, closed forms, the
event loop, scenarios, online wrappers and sweeps (see the package doc)."""
