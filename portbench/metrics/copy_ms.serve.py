"""Device ms a request in the copies between host and card (CUPTI's
memcpy HtoD and DtoH): the Restorer's image in and its result out."""


def read(ctx):
    if ctx.trace is None:
        return None
    ms = ctx.trace.ms_per_unit(lambda n: "HtoD" in n or "DtoH" in n)
    return ms if ms > 0 else None
