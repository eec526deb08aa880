"""What every entry shares: the program's data from the raw inputs."""


def program_data(api, raw, device):
    """``api.build_data`` of the simulated observations, their points and
    covariates, with the basis the simulation used, on ``device``: curves
    on a 1-D basis, or for ``family`` "hd" surfaces on a tensor basis."""
    if raw.get("family", "functional") == "hd":
        return api.build_data(raw["y"], raw["t"], family="hd",
                              basis_degrees=raw["degrees"],
                              internal_knots_list=raw["internal"],
                              boundary_knots=raw["boundary"], X=raw["X"],
                              device=device)
    return api.build_data(raw["y"], raw["t"], family="functional",
                          basis_degree=raw["degree"],
                          internal_knots=raw["internal"],
                          boundary_knots=raw["boundary"], X=raw["X"],
                          device=device)
