"""panel_width: requests a launched panel carries, the mean over the
window's panels: the requests the window sent (and submit took) over the
panels the runtime launched for them (``PanelRuntime.stats()``'s
``panels_launched``).  How full the deadline leaves the panels; a partial
panel still computes its whole width bucket (``pad_share``)."""


def read(run):
    stats = run["stats"]
    if stats["panels"] == 0:
        return None
    return stats["requests"] / stats["panels"]
