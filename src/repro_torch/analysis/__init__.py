"""Repo-wide static analysis of the port: the AST lint pass
(``repro_torch.analysis.lint``) and the plan-verification sweep
(``repro_torch.analysis.verify_sweep``)."""
