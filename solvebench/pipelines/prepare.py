"""The plain pipeline: ``prepare(A, method=…, M=…, tol=…, max_iter=…)`` on
the CSR, as a user calls it for repeated solves against one operator."""


def build(spt, A, traffic: dict, device):
    return spt.prepare(A, method=traffic["method"], M=traffic.get("M"),
                       tol=traffic["tol"], max_iter=traffic["max_iter"], device=device)
