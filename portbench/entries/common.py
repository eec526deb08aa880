"""What every entry shares: the program's data from the raw inputs."""


def program_data(api, raw, device):
    """``api.build_data`` of the simulated curves, time points and
    covariates, with the basis the simulation used, on ``device``."""
    return api.build_data(raw["y"], raw["t"], family="functional",
                          basis_degree=raw["degree"],
                          internal_knots=raw["internal"],
                          boundary_knots=raw["boundary"], X=raw["X"],
                          device=device)
