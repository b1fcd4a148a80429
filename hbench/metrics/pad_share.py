"""pad_share: the share of the columns the window's panels computed that
carried no request, in %: 1 - requests / the sum of the launched panels'
widths (``PanelRuntime.stats()["launched_widths"]``, each partial panel
padded to its 16 / 32 / 64 bucket)."""


def read(run):
    stats = run["stats"]
    if not stats["complete"] or not stats["widths"]:
        return None
    return 100.0 * (1.0 - stats["requests"] / sum(stats["widths"]))
