from omfs4d_torch.app.session import PlanningSession  # noqa: F401
