"""Self device milliseconds a training step of the MEC VJP's copies: the
port's spans ``mec_vjp.dx.dilate_pad``, ``mec_vjp.dx.flip``,
``mec_vjp.dx.crop``, ``mec_vjp.dw.stack``, ``mec_vjp.cast`` and
``mec.lower`` under ``mec_vjp``, from the readers' profiled pass (the
kernels launched inside each span, summed).  Copies made inside the row
GEMMs (``mec.rows``) and the einsums (``mec_vjp.dw.rows``) are not
counted."""
from mecbench.spans import device_pass

COPIES = {"mec_vjp.dx.dilate_pad", "mec_vjp.dx.flip", "mec_vjp.dx.crop",
          "mec_vjp.dw.stack", "mec_vjp.cast", "mec.lower"}


def read(trace):
    got = device_pass(trace)
    if got is None:
        return None
    summary, steps = got
    spans = [s for path, s in summary["paths"].items()
             if path.startswith("mec_vjp/")
             and path.rsplit("/", 1)[-1] in COPIES]
    if not spans or any(s["self_device_s"] is None for s in spans):
        return None
    return sum(s["self_device_s"] for s in spans) / steps * 1e3
