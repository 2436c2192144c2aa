"""Clouds trained in the window over the window's whole time, from the
first batch request to the last step's end on the device."""


def read(ctx):
    if not ctx.get("steps"):
        return None
    return ctx["clouds"] / ctx["window_s"]
