"""NumPy oracle: direct float64 transliterations of the reference CPU
algorithms (per-doc sweeps, per-doc viter break), used to validate the
batch-synchronous device implementations update-by-update.

Each function cites the reference equation it implements.  These are
*oracles*, not the product: deliberately naive, loop-heavy, and slow.
"""

from __future__ import annotations

import numpy as np
from scipy.special import digamma, gammaln, polygamma

EPS = float(np.spacing(1e-14))


def _softmax_cols(x):
    x = x - x.max(axis=0, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=0, keepdims=True)


class LDAOracle:
    """Reference CPU LDA (LDA.jl), float64, per-doc sweep."""

    def __init__(self, docs, V, K, beta0, alpha0=None):
        """docs: list of (terms0based, counts) numpy arrays."""
        self.docs = [(np.asarray(t, np.int64), np.asarray(c, np.float64)) for t, c in docs]
        self.M, self.V, self.K = len(docs), V, K
        self.alpha = np.ones(K) if alpha0 is None else np.asarray(alpha0, np.float64).copy()
        self.beta = np.asarray(beta0, np.float64).copy()
        self.beta_old = self.beta.copy()
        self.beta_temp = np.zeros((K, V))
        el0 = -np.euler_gamma - digamma(K)
        self.Elogtheta = [np.full(K, el0) for _ in range(self.M)]
        self.Elogtheta_old = [e.copy() for e in self.Elogtheta]
        self.gamma = [np.ones(K) for _ in range(self.M)]
        self.phi = None
        self.elbo = 0.0

    # update_phi! (LDA.jl:150-154)
    def update_phi(self, d):
        terms, _ = self.docs[d]
        phi = self.beta[:, terms] * np.exp(self.Elogtheta[d])[:, None] + EPS
        self.phi = phi / phi.sum(axis=0, keepdims=True)

    # update_gamma! (LDA.jl:143-146)
    def update_gamma(self, d):
        _, counts = self.docs[d]
        self.gamma[d] = EPS + self.alpha + self.phi @ counts

    # update_Elogtheta! (LDA.jl:136-139)
    def update_Elogtheta(self, d):
        self.Elogtheta_old[d] = self.Elogtheta[d]
        g = self.gamma[d]
        self.Elogtheta[d] = digamma(g) - digamma(g.sum())

    # update_beta! streaming stat (LDA.jl:129-132)
    def accum_beta(self, d):
        terms, counts = self.docs[d]
        np.add.at(self.beta_temp, (slice(None), terms), self.phi * counts[None, :])

    # update_beta! reset (LDA.jl:121-125)
    def swap_beta(self):
        self.beta_old = self.beta
        self.beta = self.beta_temp / self.beta_temp.sum(axis=1, keepdims=True)
        self.beta_temp = np.zeros((self.K, self.V))

    # update_alpha! (LDA.jl:97-118)
    def update_alpha(self, niter, ntol):
        El_sum = np.sum(self.Elogtheta, axis=0)
        nu = float(self.K)
        for _ in range(niter):
            rho = 1.0
            a0 = self.alpha.sum()
            grad = nu / self.alpha + self.M * (digamma(a0) - digamma(self.alpha)) + El_sum
            h_inv = -1.0 / (self.M * polygamma(1, self.alpha) + nu / self.alpha**2)
            p = (grad - grad @ h_inv / (1.0 / (self.M * polygamma(1, a0)) + h_inv.sum())) * h_inv
            while np.min(self.alpha - rho * p) < 0:
                rho *= 0.5
            self.alpha = self.alpha - rho * p
            if (rho * np.linalg.norm(grad) < ntol) and (nu / self.K < ntol):
                break
            nu *= 0.5
        self.alpha = self.alpha + EPS

    # update_elbo! (LDA.jl:50-93)
    def update_elbo(self):
        total = 0.0
        a = self.alpha
        for d in range(self.M):
            terms, counts = self.docs[d]
            phi = self.beta_old[:, terms] * np.exp(self.Elogtheta_old[d])[:, None] + EPS
            phi = phi / phi.sum(axis=0, keepdims=True)
            g, el = self.gamma[d], self.Elogtheta[d]
            e_ptheta = gammaln(a.sum()) - gammaln(a).sum() + (a - 1) @ el
            e_pz = (phi @ counts) @ el
            e_pw = np.sum(phi * np.log(self.beta[:, terms] + EPS) * counts[None, :])
            a0 = g.sum()
            lmnb = gammaln(g).sum() - gammaln(a0)
            e_qtheta_entropy = lmnb + (a0 - self.K) * digamma(a0) - np.sum(
                (g - 1) * digamma(g)
            )
            e_qz_entropy = -np.sum(counts * np.sum(phi * np.log(phi), axis=0))
            total += e_ptheta + e_pz + e_pw + e_qtheta_entropy + e_qz_entropy
        self.elbo = total
        return total

    # train! (LDA.jl:161-191)
    def train(self, iters, viter=10, vtol=None, niter=1000, ntol=None):
        vtol = 1.0 / self.K**2 if vtol is None else vtol
        ntol = 1.0 / self.K**2 if ntol is None else ntol
        elbos = []
        for _ in range(iters):
            for d in range(self.M):
                for _v in range(viter):
                    self.update_phi(d)
                    self.update_gamma(d)
                    self.update_Elogtheta(d)
                    if np.linalg.norm(self.Elogtheta[d] - self.Elogtheta_old[d]) < vtol:
                        break
                self.update_phi_final_stat(d)
            self.swap_beta()
            self.update_alpha(niter, ntol)
            elbos.append(self.update_elbo())
        return elbos

    def update_phi_final_stat(self, d):
        # The reference uses phi as left by the last update_phi! call
        # (computed from Elogtheta before its final in-loop update,
        # i.e. Elogtheta_old).
        terms, _ = self.docs[d]
        phi = self.beta[:, terms] * np.exp(self.Elogtheta_old[d])[:, None] + EPS
        self.phi = phi / phi.sum(axis=0, keepdims=True)
        self.accum_beta(d)


class FLDAOracle:
    """Reference CPU fLDA (fLDA.jl), float64, per-doc sweep."""

    def __init__(self, docs, V, K, beta0, kappa0):
        self.docs = [(np.asarray(t, np.int64), np.asarray(c, np.float64)) for t, c in docs]
        self.M, self.V, self.K = len(docs), V, K
        self.eta = 0.5
        self.alpha = np.ones(K)
        self.kappa = np.asarray(kappa0, np.float64).copy()
        self.kappa_old = self.kappa.copy()
        self.kappa_temp = np.zeros(V)
        self.beta = np.asarray(beta0, np.float64).copy()
        self.beta_old = self.beta.copy()
        self.beta_temp = np.zeros((K, V))
        el0 = -np.euler_gamma - digamma(K)
        self.Elogtheta = [np.full(K, el0) for _ in range(self.M)]
        self.Elogtheta_old = [e.copy() for e in self.Elogtheta]
        self.gamma = [np.ones(K) for _ in range(self.M)]
        self.tau = [np.full(len(t), self.eta) for t, _ in self.docs]
        self.tau_old = [t.copy() for t in self.tau]
        self.phi = None
        self.elbo = 0.0
        self.C = [c.sum() for _, c in self.docs]

    # update_phi! (fLDA.jl:204-207)
    def update_phi(self, d):
        terms, _ = self.docs[d]
        x = self.tau[d][None, :] * np.log(self.beta[:, terms] + EPS) + self.Elogtheta[d][:, None]
        self.phi = _softmax_cols(x)

    # update_tau! (fLDA.jl:195-200)
    def update_tau(self, d):
        self.tau_old[d] = self.tau[d]
        terms, _ = self.docs[d]
        prod = np.prod(self.beta[:, terms] ** (-self.phi), axis=0)
        self.tau[d] = self.eta / (self.eta + (1 - self.eta) * self.kappa[terms] * prod + EPS)

    # update_gamma!/update_Elogtheta! are LDA's own (fLDA.jl:181-191)
    update_gamma = LDAOracle.update_gamma
    update_Elogtheta = LDAOracle.update_Elogtheta

    # update_beta! / update_kappa! streaming stats (fLDA.jl:174-177, 160-163)
    def accum(self, d):
        terms, counts = self.docs[d]
        np.add.at(self.beta_temp, (slice(None), terms),
                  self.phi * (self.tau[d] * counts)[None, :])
        np.add.at(self.kappa_temp, terms, (1 - self.tau[d]) * counts)

    def swap(self):
        self.beta_old = self.beta
        self.beta = self.beta_temp / self.beta_temp.sum(axis=1, keepdims=True)
        self.beta_temp = np.zeros((self.K, self.V))
        self.kappa_old = self.kappa
        self.kappa = self.kappa_temp / self.kappa_temp.sum()
        self.kappa_temp = np.zeros(self.V)

    def update_alpha(self, niter, ntol):
        LDAOracle.update_alpha(self, niter, ntol)

    # update_eta! (fLDA.jl:122-124)
    def update_eta(self):
        self.eta = sum(
            self.tau[d] @ self.docs[d][1] for d in range(self.M)
        ) / sum(self.C)

    # update_elbo! (fLDA.jl:109-118)
    def update_elbo(self):
        total = 0.0
        a = self.alpha
        for d in range(self.M):
            terms, counts = self.docs[d]
            x = self.tau_old[d][None, :] * np.log(self.beta_old[:, terms] + EPS) \
                + self.Elogtheta_old[d][:, None]
            phi = _softmax_cols(x)
            g, el, ta = self.gamma[d], self.Elogtheta[d], self.tau[d]
            e_ptheta = gammaln(a.sum()) - gammaln(a).sum() + (a - 1) @ el
            tc = ta @ counts
            e_pc = np.log(self.eta**tc * (1 - self.eta) ** (self.C[d] - tc) + EPS)
            e_pz = (phi @ counts) @ el
            e_pw = np.sum(phi * np.log(self.beta[:, terms] + EPS) * (counts * ta)[None, :]) \
                + (counts * (1 - ta)) @ np.log(self.kappa[terms] + EPS)
            a0 = g.sum()
            e_qtheta = (gammaln(g).sum() - gammaln(a0)) + (a0 - self.K) * digamma(a0) \
                - np.sum((g - 1) * digamma(g))
            with np.errstate(divide="ignore", invalid="ignore"):
                tl = np.where(ta > 0, ta * np.log(ta), 0.0)
                tl1 = np.where(ta < 1, (1 - ta) * np.log(1 - ta), 0.0)
            e_qc = -(counts @ (tl + tl1))
            e_qz = -np.sum(counts * np.sum(phi * np.log(phi), axis=0))
            total += e_ptheta + e_pc + e_pz + e_pw + e_qtheta + e_qc + e_qz
        self.elbo = total
        return total

    # train! (fLDA.jl:214-248)
    def train(self, iters, viter=10, vtol=None, niter=1000, ntol=None):
        vtol = 1.0 / self.K**2 if vtol is None else vtol
        ntol = 1.0 / self.K**2 if ntol is None else ntol
        elbos = []
        for _ in range(iters):
            for d in range(self.M):
                for _v in range(viter):
                    self.update_phi(d)
                    self.update_tau(d)
                    self.update_gamma(d)
                    self.update_Elogtheta(d)
                    if np.linalg.norm(self.Elogtheta[d] - self.Elogtheta_old[d]) < vtol:
                        break
                # final phi for stats = f(beta, tau_old, Elogtheta_old)
                terms, _ = self.docs[d]
                x = self.tau_old[d][None, :] * np.log(self.beta[:, terms] + EPS) \
                    + self.Elogtheta_old[d][:, None]
                self.phi = _softmax_cols(x)
                self.accum(d)
            self.swap()
            self.update_alpha(niter, ntol)
            self.update_eta()
            elbos.append(self.update_elbo())
        return elbos


class CTMOracle:
    """Reference CPU CTM (CTM.jl), float64, per-doc sweep."""

    def __init__(self, docs, V, K, beta0):
        self.docs = [(np.asarray(t, np.int64), np.asarray(c, np.float64)) for t, c in docs]
        self.M, self.V, self.K = len(docs), V, K
        self.mu = np.zeros(K)
        self.sigma = np.eye(K)
        self.invsigma = np.eye(K)
        self.beta = np.asarray(beta0, np.float64).copy()
        self.beta_old = self.beta.copy()
        self.beta_temp = np.zeros((K, V))
        self.lam = [np.zeros(K) for _ in range(self.M)]
        self.lam_old = [np.zeros(K) for _ in range(self.M)]
        self.vsq = [np.ones(K) for _ in range(self.M)]
        self.logzeta = np.full(self.M, 0.5)
        self.C = [c.sum() for _, c in self.docs]
        self.phi = None
        self.elbo = 0.0

    def update_phi(self, d):
        terms, _ = self.docs[d]
        with np.errstate(divide="ignore"):
            self.phi = _softmax_cols(np.log(self.beta[:, terms]) + self.lam[d][:, None])

    def update_logzeta(self, d):
        x = self.lam[d] + 0.5 * self.vsq[d]
        m = x.max()
        self.logzeta[d] = m + np.log(np.exp(x - m).sum())

    # update_vsq! (CTM.jl:146-165)
    def update_vsq(self, d, niter, ntol):
        for i in range(self.K):
            for _ in range(niter):
                rho = 1.0
                e = self.C[d] * np.exp(self.lam[d][i] + 0.5 * self.vsq[d][i] - self.logzeta[d])
                grad = -0.5 * (self.invsigma[i, i] + e - 1.0 / self.vsq[d][i])
                invhess = -1.0 / (0.25 * e + 0.5 / self.vsq[d][i] ** 2)
                p = invhess * grad
                while self.vsq[d][i] - rho * p <= 0:
                    rho *= 0.5
                self.vsq[d][i] -= rho * p
                if rho * abs(grad) < ntol:
                    break
        self.vsq[d] = self.vsq[d] + EPS

    # update_lambda! (CTM.jl:129-142)
    def update_lambda(self, d, niter, ntol):
        self.lam_old[d] = self.lam[d]
        _, counts = self.docs[d]
        lam = self.lam[d].copy()
        pc = self.phi @ counts
        for _ in range(niter):
            e = self.C[d] * np.exp(lam + 0.5 * self.vsq[d] - self.logzeta[d])
            grad = self.invsigma @ (self.mu - lam) + pc - e
            neg_hess = self.invsigma + np.diag(e)
            lam = lam + np.linalg.solve(neg_hess, grad)
            if np.linalg.norm(grad) < ntol:
                break
        self.lam[d] = lam

    def accum_beta(self, d):
        terms, counts = self.docs[d]
        # last phi = f(beta, lambda_old)
        with np.errstate(divide="ignore"):
            self.phi = _softmax_cols(np.log(self.beta[:, terms]) + self.lam_old[d][:, None])
        np.add.at(self.beta_temp, (slice(None), terms), self.phi * counts[None, :])

    def swap_beta(self):
        self.beta_old = self.beta
        self.beta = self.beta_temp / self.beta_temp.sum(axis=1, keepdims=True)
        self.beta_temp = np.zeros((self.K, self.V))

    # update_sigma! with old mu, then update_mu! (CTM.jl:102-111, 206-208)
    def update_sigma_mu(self):
        lam = np.stack(self.lam)  # [M, K]
        centered = lam - self.mu
        self.sigma = (np.diag(np.sum(self.vsq, axis=0)) + centered.T @ centered) / self.M
        self.sigma = 0.5 * (self.sigma + self.sigma.T)
        self.invsigma = np.linalg.inv(self.sigma)
        self.invsigma = 0.5 * (self.invsigma + self.invsigma.T)
        self.mu = lam.sum(axis=0) / self.M

    # update_elbo! (CTM.jl:89-98)
    def update_elbo(self):
        total = 0.0
        sign, logdet_inv = np.linalg.slogdet(self.invsigma)
        assert sign > 0, "invsigma lost positive-definiteness"
        for d in range(self.M):
            terms, counts = self.docs[d]
            with np.errstate(divide="ignore"):
                phi = _softmax_cols(np.log(self.beta_old[:, terms]) + self.lam_old[d][:, None])
            la, v, lz = self.lam[d], self.vsq[d], self.logzeta[d]
            diff = la - self.mu
            e_peta = 0.5 * (logdet_inv - self.K * np.log(2 * np.pi)
                            - np.diag(self.invsigma) @ v - diff @ self.invsigma @ diff)
            e_pz = (phi.T @ la) @ counts - self.C[d] * (
                np.exp(la + 0.5 * v - lz).sum() + lz - 1.0
            )
            e_pw = np.sum(phi * np.log(self.beta[:, terms] + EPS) * counts[None, :])
            e_qeta = 0.5 * self.K * (1 + np.log(2 * np.pi)) + 0.5 * np.log(v).sum()
            e_qz = -np.sum(counts * np.sum(phi * np.log(phi), axis=0))
            total += e_peta + e_pz + e_pw + e_qeta + e_qz
        self.elbo = total
        return total

    # train! (CTM.jl:185-217)
    def train(self, iters, viter=10, vtol=None, niter=1000, ntol=None):
        vtol = 1.0 / self.K**2 if vtol is None else vtol
        ntol = 1.0 / self.K**2 if ntol is None else ntol
        elbos = []
        for _ in range(iters):
            for d in range(self.M):
                for _v in range(viter):
                    self.update_phi(d)
                    self.update_logzeta(d)
                    self.update_vsq(d, niter, ntol)
                    self.update_lambda(d, niter, ntol)
                    if np.linalg.norm(self.lam[d] - self.lam_old[d]) < vtol:
                        break
                self.accum_beta(d)
            self.swap_beta()
            self.update_sigma_mu()
            elbos.append(self.update_elbo())
        return elbos


class FCTMOracle(CTMOracle):
    """Reference CPU fCTM (fCTM.jl), float64, per-doc sweep."""

    def __init__(self, docs, V, K, beta0, kappa0):
        super().__init__(docs, V, K, beta0)
        self.eta = 0.5
        self.kappa = np.asarray(kappa0, np.float64).copy()
        self.kappa_old = self.kappa.copy()
        self.kappa_temp = np.zeros(V)
        self.tau = [np.full(len(t), self.eta) for t, _ in self.docs]
        self.tau_old = [t.copy() for t in self.tau]

    # update_phi! (fCTM.jl:230-233)
    def update_phi(self, d):
        terms, _ = self.docs[d]
        x = self.tau[d][None, :] * np.log(self.beta[:, terms] + EPS) + self.lam[d][:, None]
        self.phi = _softmax_cols(x)

    # update_tau! (fCTM.jl:221-226 — same equation as fLDA.jl:195-200)
    update_tau = FLDAOracle.update_tau

    # stats (fCTM.jl:168-171, 154-157) with last phi = f(beta, tau_old, lam_old)
    def accum(self, d):
        terms, counts = self.docs[d]
        x = self.tau_old[d][None, :] * np.log(self.beta[:, terms] + EPS) \
            + self.lam_old[d][:, None]
        self.phi = _softmax_cols(x)
        np.add.at(self.beta_temp, (slice(None), terms),
                  self.phi * (self.tau[d] * counts)[None, :])
        np.add.at(self.kappa_temp, terms, (1 - self.tau[d]) * counts)

    def swap(self):
        self.swap_beta()
        self.kappa_old = self.kappa
        self.kappa = self.kappa_temp / self.kappa_temp.sum()
        self.kappa_temp = np.zeros(self.V)

    # update_elbo! (fCTM.jl:114-124)
    def update_elbo(self):
        total = 0.0
        sign, logdet_inv = np.linalg.slogdet(self.invsigma)
        assert sign > 0, "invsigma lost positive-definiteness"
        for d in range(self.M):
            terms, counts = self.docs[d]
            x = self.tau_old[d][None, :] * np.log(self.beta_old[:, terms] + EPS) \
                + self.lam_old[d][:, None]
            phi = _softmax_cols(x)
            la, v, lz, ta = self.lam[d], self.vsq[d], self.logzeta[d], self.tau[d]
            diff = la - self.mu
            e_peta = 0.5 * (logdet_inv - self.K * np.log(2 * np.pi)
                            - np.diag(self.invsigma) @ v - diff @ self.invsigma @ diff)
            tc = ta @ counts
            e_pc = np.log(self.eta**tc * (1 - self.eta) ** (self.C[d] - tc) + EPS)
            e_pz = (phi.T @ la) @ counts - self.C[d] * (
                np.exp(la + 0.5 * v - lz).sum() + lz - 1.0
            )
            e_pw = np.sum(phi * np.log(self.beta[:, terms] + EPS) * (counts * ta)[None, :]) \
                + (counts * (1 - ta)) @ np.log(self.kappa[terms] + EPS)
            e_qeta = 0.5 * self.K * (1 + np.log(2 * np.pi)) + 0.5 * np.log(v).sum()
            with np.errstate(divide="ignore", invalid="ignore"):
                tl = np.where(ta > 0, ta * np.log(ta), 0.0)
                tl1 = np.where(ta < 1, (1 - ta) * np.log(1 - ta), 0.0)
            e_qc = -(counts @ (tl + tl1))
            e_qz = -np.sum(counts * np.sum(phi * np.log(phi), axis=0))
            total += e_peta + e_pc + e_pz + e_pw + e_qeta + e_qc + e_qz
        self.elbo = total
        return total

    # train! (fCTM.jl:240-276) — note lambda BEFORE vsq; eta never updated
    def train(self, iters, viter=10, vtol=None, niter=1000, ntol=None):
        vtol = 1.0 / self.K**2 if vtol is None else vtol
        ntol = 1.0 / self.K**2 if ntol is None else ntol
        elbos = []
        for _ in range(iters):
            for d in range(self.M):
                for _v in range(viter):
                    self.update_phi(d)
                    self.update_tau(d)
                    self.update_logzeta(d)
                    self.update_lambda(d, niter, ntol)
                    self.update_vsq(d, niter, ntol)
                    if np.linalg.norm(self.lam[d] - self.lam_old[d]) < vtol:
                        break
                self.accum(d)
            self.swap()
            self.update_sigma_mu()
            elbos.append(self.update_elbo())
        return elbos


class CTPFOracle:
    """Reference CPU CTPF (CTPF.jl), float64, per-doc sweep, with the
    O(count) binomial-pdf ELBO terms computed exactly as the reference
    does (CTPF.jl:116,127,138,180-195)."""

    A = B = C = D = E = F = G = H = 0.1  # CTPF.jl:81

    def __init__(self, docs, V, U, K, alef0):
        """docs: list of (terms0, counts, readers0, ratings)."""
        self.docs = [
            (np.asarray(t, np.int64), np.asarray(c, np.float64),
             np.asarray(r, np.int64), np.asarray(ra, np.float64))
            for t, c, r, ra in docs
        ]
        self.M, self.V, self.U, self.K = len(docs), V, U, K
        self.alef = np.asarray(alef0, np.float64).copy()
        self.alef_old = self.alef.copy()
        self.alef_temp = np.full((K, V), self.A)
        self.he = np.ones((K, U))
        self.he_old = self.he.copy()
        self.he_temp = np.full((K, U), self.E)
        self.bet = np.ones(K); self.bet_old = np.ones(K)
        self.vav = np.ones(K); self.vav_old = np.ones(K)
        self.gimel = [np.ones(K) for _ in range(self.M)]
        self.gimel_old = [np.ones(K) for _ in range(self.M)]
        self.zayin = [np.ones(K) for _ in range(self.M)]
        self.zayin_old = [np.ones(K) for _ in range(self.M)]
        self.dalet = np.ones(K); self.dalet_old = np.ones(K)
        self.het = np.ones(K); self.het_old = np.ones(K)
        self.phi = None
        self.xi = None
        self.elbo = 0.0

    def _phi_of(self, d, gimel, dalet, bet, alef):
        terms = self.docs[d][0]
        x = digamma(gimel)[:, None] - np.log(dalet)[:, None] - np.log(bet)[:, None] \
            + digamma(alef[:, terms])
        return _softmax_cols(x)

    def _xi_of(self, d, gimel, zayin, dalet, het, vav, he):
        readers = self.docs[d][2]
        top = digamma(gimel)[:, None] - np.log(dalet)[:, None] - np.log(vav)[:, None] \
            + digamma(he[:, readers])
        bot = digamma(zayin)[:, None] - np.log(het)[:, None] - np.log(vav)[:, None] \
            + digamma(he[:, readers])
        return _softmax_cols(np.vstack([top, bot]))

    # update_xi! / update_phi! (CTPF.jl:327-337)
    def update_xi(self, d):
        self.xi = self._xi_of(d, self.gimel[d], self.zayin[d], self.dalet,
                              self.het, self.vav, self.he)

    def update_phi(self, d):
        self.phi = self._phi_of(d, self.gimel[d], self.dalet, self.bet, self.alef)

    # update_zayin! / update_gimel! (CTPF.jl:309-323)
    def update_zayin(self, d):
        self.zayin_old[d] = self.zayin[d]
        ratings = self.docs[d][3]
        self.zayin[d] = self.G + self.xi[self.K:, :] @ ratings

    def update_gimel(self, d):
        self.gimel_old[d] = self.gimel[d]
        counts, ratings = self.docs[d][1], self.docs[d][3]
        self.gimel[d] = self.C + self.phi @ counts + self.xi[: self.K, :] @ ratings

    # streaming stats (CTPF.jl:259-277) with last phi/xi = f(*_old)
    def accum(self, d):
        terms, counts, readers, ratings = self.docs[d]
        phi = self._phi_of(d, self.gimel_old[d], self.dalet, self.bet, self.alef)
        xi = self._xi_of(d, self.gimel_old[d], self.zayin_old[d], self.dalet,
                         self.het, self.vav, self.he)
        np.add.at(self.alef_temp, (slice(None), terms), phi * counts[None, :])
        if self.U > 0:
            np.add.at(self.he_temp, (slice(None), readers),
                      (xi[: self.K, :] + xi[self.K:, :]) * ratings[None, :])

    # global updates, reference order (CTPF.jl:366-371)
    def global_updates(self):
        self.he_old = self.he
        self.he = self.he_temp
        self.he_temp = np.full((self.K, self.U), self.E)
        self.alef_old = self.alef
        self.alef = self.alef_temp
        self.alef_temp = np.full((self.K, self.V), self.A)
        he_sum = self.he.sum(axis=1) if self.U > 0 else np.zeros(self.K)
        self.dalet_old = self.dalet
        self.dalet = self.D + self.alef.sum(axis=1) / self.bet + he_sum / self.vav
        self.het_old = self.het
        self.het = self.H + he_sum / self.vav
        gimel_sum = np.sum(self.gimel, axis=0)
        zayin_sum = np.sum(self.zayin, axis=0)
        self.bet_old = self.bet
        self.bet = self.B + gimel_sum / self.dalet
        self.vav_old = self.vav
        self.vav = self.F + gimel_sum / self.dalet + zayin_sum / self.het

    @staticmethod
    def _Elgamma_binom(n, p):
        """Σ_y pdf(Binom(n,p), y)·lnΓ(y+1), reference's exact term."""
        from scipy.stats import binom as sbinom

        n = int(n)
        ys = np.arange(n + 1)
        return float(sbinom.pmf(ys, n, p) @ gammaln(ys + 1.0))

    def update_elbo(self):
        # Elogpbeta − Elogqbeta (CTPF.jl:144-150, 198-204)
        dg_alef = digamma(self.alef)
        e_pbeta = self.V * self.K * (self.A * np.log(self.B) - gammaln(self.A)) \
            + np.sum((self.A - 1) * (dg_alef - np.log(self.bet)[:, None])
                     - self.B * self.alef / self.bet[:, None])
        ent_beta = np.sum(
            self.alef - np.log(self.bet)[:, None] + gammaln(self.alef)
            + (1 - self.alef) * dg_alef
        )
        total = e_pbeta + ent_beta
        if self.U > 0:
            dg_he = digamma(self.he)
            e_peta = self.U * self.K * (self.E * np.log(self.F) - gammaln(self.E)) \
                + np.sum((self.E - 1) * (dg_he - np.log(self.vav)[:, None])
                         - self.F * self.he / self.vav[:, None])
            ent_eta = np.sum(
                self.he - np.log(self.vav)[:, None] + gammaln(self.he)
                + (1 - self.he) * dg_he
            )
            total += e_peta + ent_eta

        he_sum = self.he.sum(axis=1) if self.U > 0 else np.zeros(self.K)
        alef_sum = self.alef.sum(axis=1)
        for d in range(self.M):
            terms, counts, readers, ratings = self.docs[d]
            phi = self._phi_of(d, self.gimel_old[d], self.dalet_old, self.bet_old,
                               self.alef_old)
            xi = self._xi_of(d, self.gimel_old[d], self.zayin_old[d], self.dalet_old,
                             self.het_old, self.vav_old, self.he_old)
            gi, za = self.gimel[d], self.zayin[d]
            dg_gi, dg_za = digamma(gi), digamma(za)

            # Elogpya (CTPF.jl:111-119)
            x = -np.dot(gi / (self.dalet * self.vav), he_sum)
            for u, (re, ra) in enumerate(zip(readers, ratings)):
                for i in range(self.K):
                    x += ra * xi[i, u] * (dg_gi[i] - np.log(self.dalet[i])
                                          + digamma(self.he[i, re]) - np.log(self.vav[i]))
                    x -= self._Elgamma_binom(ra, xi[i, u])
            total += x
            # Elogpyb (CTPF.jl:122-130)
            x = -np.dot(za / (self.het * self.vav), he_sum)
            for u, (re, ra) in enumerate(zip(readers, ratings)):
                for i in range(self.K):
                    x += ra * xi[self.K + i, u] * (
                        dg_za[i] - np.log(self.het[i])
                        + digamma(self.he[i, re]) - np.log(self.vav[i])
                    )
                    x -= self._Elgamma_binom(ra, xi[self.K + i, u])
            total += x
            # Elogpz (CTPF.jl:133-141)
            x = -np.dot(gi / (self.dalet * self.bet), alef_sum)
            for n, (j, cc) in enumerate(zip(terms, counts)):
                for i in range(self.K):
                    x += cc * phi[i, n] * (dg_gi[i] - np.log(self.dalet[i])
                                           + digamma(self.alef[i, j]) - np.log(self.bet[i]))
                    x -= self._Elgamma_binom(cc, phi[i, n])
            total += x
            # Elogptheta − Elogqtheta (CTPF.jl:153-159, 207-213)
            total += self.K * (self.C * np.log(self.D) - gammaln(self.C)) \
                + np.sum((self.C - 1) * (dg_gi - np.log(self.dalet))
                         - self.D * gi / self.dalet)
            total += np.sum(gi - np.log(self.dalet) + gammaln(gi) + (1 - gi) * dg_gi)
            # Elogpepsilon − Elogqepsilon (CTPF.jl:171-177, 225-231)
            total += self.K * (self.G * np.log(self.H) - gammaln(self.G)) \
                + np.sum((self.G - 1) * (dg_za - np.log(self.het))
                         - self.H * za / self.het)
            total += np.sum(za - np.log(self.het) + gammaln(za) + (1 - za) * dg_za)
            # −Elogqy (CTPF.jl:180-186): exact multinomial entropy
            for u, ra in enumerate(ratings):
                hh = -gammaln(ra + 1.0)
                for i in range(2 * self.K):
                    hh += self._Elgamma_binom(ra, xi[i, u])
                pl = np.where(xi[:, u] > 0, xi[:, u] * np.log(np.where(xi[:, u] > 0, xi[:, u], 1.0)), 0.0)
                hh -= ra * pl.sum()
                total += hh
            # −Elogqz (CTPF.jl:189-195)
            for n, cc in enumerate(counts):
                hh = -gammaln(cc + 1.0)
                for i in range(self.K):
                    hh += self._Elgamma_binom(cc, phi[i, n])
                pl = np.where(phi[:, n] > 0, phi[:, n] * np.log(np.where(phi[:, n] > 0, phi[:, n], 1.0)), 0.0)
                hh -= cc * pl.sum()
                total += hh
        self.elbo = total
        return total

    # train! (CTPF.jl:344-376)
    def train(self, iters, viter=10, vtol=None, with_elbo=True):
        vtol = 1.0 / self.K**2 if vtol is None else vtol
        elbos = []
        for _ in range(iters):
            for d in range(self.M):
                for _v in range(viter):
                    self.update_xi(d)
                    self.update_phi(d)
                    self.update_zayin(d)
                    self.update_gimel(d)
                    if np.linalg.norm(self.gimel[d] - self.gimel_old[d]) < vtol:
                        break
                self.accum(d)
            self.global_updates()
            if with_elbo:
                elbos.append(self.update_elbo())
        return elbos


class DTMOracle:
    """Reference v0.6 DTM (v0.6/src/DTM.jl), float64, per-doc sweep.

    The ELBO is the reference's ``updateELBO!`` (DTM.jl:119-174)
    transliterated term by term.  The update trajectory mirrors the
    repo's documented divergences from the v0.6 reference (PARITY.md
    "Known reference bugs deliberately fixed") so the two traces can be
    compared:

    * ``Elogtheta`` is refreshed from the new gamma every viter
      iteration (the reference only refreshes it in ``fixmodel!``);
    * the overflow guard is the log-domain ``maximum(x)`` of
      ``updateMbeta!`` (DTM.jl:227), applied consistently;
    * the CG gradient is the COMPLETED Jacobian recursion (the
      reference truncates the backward ``mbetagrad`` recursion at
      t = s and drops the smoothed-anchor derivative, DTM.jl:265-268);
    * the CG control flow follows the repo's safeguarded variant of
      DTM.jl:286-301 (Polak–Ribière clipped to [0,1] as the reference
      does, plus: restart on a non-ascent direction, rejection of a
      step that fails the Armijo condition after back-tracking, rho
      capped at 1, and a cgtol stop on small accepted improvement);
    * phi inside the ELBO is recomputed from the post-step state
      (post-CG mbeta + final Elogtheta/lzeta), where the reference
      reuses the E-step phi computed against the pre-CG mbeta.

    Hyperparameters fixed as in the reference constructor
    (DTM.jl:98-103): sigmasq = bsq = v0 = 1, m0 = 0.
    """

    S2 = B2 = V0 = 1.0
    M0 = 0.0

    def __init__(self, docs, sid, V, K, T, betahat0, alpha0=None):
        """docs: list of (terms0based, counts); sid: 0-based slice ids."""
        self.docs = [(np.asarray(t, np.int64), np.asarray(c, np.float64))
                     for t, c in docs]
        self.sid = np.asarray(sid, np.int64)
        self.M, self.V, self.K, self.T = len(docs), V, K, T
        self.alpha = (np.ones((T, K)) if alpha0 is None
                      else np.asarray(alpha0, np.float64).copy())
        self.betahat = np.asarray(betahat0, np.float64).copy()
        self.gamma = np.ones((self.M, K))
        self.Elogtheta = digamma(self.gamma) - digamma(
            self.gamma.sum(1, keepdims=True))
        self.lzeta = np.ones(self.M)
        self.v_filt, self.vbeta = self._variance_smoother()
        self.mbeta = self._mean_smoother(self.betahat)

    # updateVbeta! (DTM.jl:231-242); eps as in the repo's scan carries
    def _variance_smoother(self):
        T, K, V = self.T, self.K, self.V
        v = np.zeros((T, K, V))
        vp = np.full((K, V), self.V0)
        for t in range(T):
            v[t] = (self.B2 / (vp + self.S2 + self.B2)) * (vp + self.S2) + EPS
            vp = v[t]
        vb = np.zeros((T, K, V))
        vb[T - 1] = v[T - 1]
        for t in range(T - 1, 0, -1):
            vb[t - 1] = (v[t - 1] + (v[t - 1] / (v[t - 1] + self.S2)) ** 2
                         * (vb[t] - v[t - 1] - self.S2) + EPS)
        return v, vb

    # updateMbeta! (DTM.jl:209-223)
    def _mean_smoother(self, bh):
        T, K, V = self.T, self.K, self.V
        m = np.zeros((T, K, V))
        mp = np.full((K, V), self.M0)
        vp = np.full((K, V), self.V0)
        for t in range(T):
            q = self.B2 / (vp + self.S2 + self.B2)
            m[t] = q * mp + (1.0 - q) * bh[t]
            mp = m[t]
            vp = self.v_filt[t]
        mb = np.zeros((T, K, V))
        mb[T - 1] = m[T - 1]
        for t in range(T - 1, 0, -1):
            q = self.S2 / (self.v_filt[t - 1] + self.S2)
            mb[t - 1] = q * m[t - 1] + (1.0 - q) * mb[t]
        return mb

    # smoothed time-0 anchors (updateMbeta!/updateVbeta!, DTM.jl:222,241)
    def _anchors(self):
        q0 = self.S2 / (self.V0 + self.S2)
        mbeta0 = q0 * self.M0 + (1.0 - q0) * self.mbeta[0]
        vbeta0 = self.V0 + (self.V0 / (self.V0 + self.S2)) ** 2 * (
            self.vbeta[0] - self.V0 - self.S2)
        return mbeta0, vbeta0

    # per-slice overflow-safe pieces of Σ_v exp(mbeta + vbeta/2)
    # (updateMbeta!, DTM.jl:225-228; log-domain max per PARITY.md)
    def _ovfl(self):
        x = self.mbeta + 0.5 * self.vbeta
        maxl = x.max(axis=(1, 2))                       # [T]
        rowsum = np.exp(x - maxl[:, None, None]).sum(axis=2)  # [T, K]
        return maxl, rowsum

    def _phi(self, d, maxl, rowsum):
        t = self.sid[d]
        terms, _ = self.docs[d]
        decay = np.exp(maxl[t] - self.lzeta[d]) * rowsum[t]     # [K]
        logits = (self.mbeta[t][:, terms] - decay[:, None]
                  + self.Elogtheta[d][:, None])
        return _softmax_cols(logits)

    # updateGamma!/updatePhi!/updateLzeta! fixpoint (DTM.jl:199-207,
    # 306-309, train! inner loop DTM.jl:317-328)
    def estep(self, viter, vtol, maxl, rowsum):
        for d in range(self.M):
            t = self.sid[d]
            _, counts = self.docs[d]
            for _ in range(viter):
                phi = self._phi(d, maxl, rowsum)
                pc = phi @ counts
                g_new = self.alpha[t] + pc + EPS
                delta = np.linalg.norm(g_new - self.gamma[d])
                self.gamma[d] = g_new
                self.Elogtheta[d] = digamma(g_new) - digamma(g_new.sum())
                self.lzeta[d] = maxl[t] + np.log(pc @ rowsum[t] + EPS)
                if delta < vtol:
                    break

    # per-slice sufficient statistics from the final phi
    def _cg_stats(self, maxl, rowsum):
        A = np.zeros((self.T, self.K, self.V))
        wz = np.zeros((self.T, self.K))
        for d in range(self.M):
            t = self.sid[d]
            terms, counts = self.docs[d]
            phi = self._phi(d, maxl, rowsum)
            np.add.at(A[t], (slice(None), terms), phi * counts[None, :])
            wz[t] += np.exp(-self.lzeta[d]) * (phi @ counts)
        return A, wz

    # updateAlpha! (DTM.jl:176-197), per slice
    def update_alpha(self, niter, ntol):
        for t in range(self.T):
            docs_t = np.nonzero(self.sid == t)[0]
            St = max(len(docs_t), 1.0)
            elsum = (self.Elogtheta[docs_t].sum(0) if len(docs_t)
                     else np.zeros(self.K))
            a = self.alpha[t].copy()
            nu = float(self.K)
            for _ in range(niter):
                a0 = a.sum()
                grad = nu / a + St * (digamma(a0) - digamma(a)) + elsum
                h_inv = -1.0 / (St * polygamma(1, a) + nu / a**2)
                p = (grad - grad @ h_inv
                     / (1.0 / (St * polygamma(1, a0)) + h_inv.sum())) * h_inv
                rho = 1.0
                while np.min(a - rho * p) < 0:
                    rho *= 0.5
                a = a - rho * p
                if (rho * np.linalg.norm(grad) < ntol) and (nu / self.K < ntol):
                    break
                nu *= 0.5
            self.alpha[t] = a + EPS

    # calcstep (DTM.jl:254): Σ_t Elogpw + Elogpbeta as a function of
    # betahat through the smoother, constants dropped
    def _cg_objective(self, bh, A, wz):
        mb = self._mean_smoother(bh)
        lin = np.sum(A * mb)
        rowsum = np.exp(mb + 0.5 * self.vbeta).sum(axis=2)   # [T, K]
        expterm = np.sum(wz * rowsum)
        q0 = self.S2 / (self.V0 + self.S2)
        mb0 = q0 * self.M0 + (1.0 - q0) * mb[0]
        prev = np.concatenate([mb0[None], mb[:-1]], 0)
        pbeta = -(0.5 / self.S2) * np.sum((mb - prev) ** 2)
        return lin - expterm + pbeta

    # gradient via the COMPLETED Jacobian recursions (mgrad/mbetagrad/
    # betahatgrad, DTM.jl:247-284; completion per PARITY.md)
    def _cg_gradient(self, bh, A, wz):
        T = self.T
        v = self.v_filt
        vprev = np.concatenate([np.full((1, self.K, self.V), self.V0),
                                v[:-1]], 0)
        mb = self._mean_smoother(bh)
        q0 = self.S2 / (self.V0 + self.S2)
        mb0 = q0 * self.M0 + (1.0 - q0) * mb[0]
        Eexp = np.exp(mb + 0.5 * self.vbeta)
        grad = np.zeros_like(bh)
        for s in range(T):
            mgrad = np.zeros((T, self.K, self.V))
            mgrad[s] = 1.0 - self.B2 / (vprev[s] + self.S2 + self.B2)
            for t in range(s + 1, T):
                mgrad[t] = (self.B2 / (v[t - 1] + self.S2 + self.B2)) * mgrad[t - 1]
            mbg = np.zeros((T, self.K, self.V))
            mbg[T - 1] = mgrad[T - 1]
            for t in range(T - 1, 0, -1):
                q = self.S2 / (v[t - 1] + self.S2)
                mbg[t - 1] = q * mgrad[t - 1] + (1.0 - q) * mbg[t]
            mb0g = (1.0 - q0) * mbg[0]
            g = -(1.0 / self.S2) * (mb[0] - mb0) * (mbg[0] - mb0g)
            for t in range(1, T):
                g += -(1.0 / self.S2) * (mb[t] - mb[t - 1]) * (mbg[t] - mbg[t - 1])
            for t in range(T):
                g += (A[t] - wz[t][:, None] * Eexp[t]) * mbg[t]
            grad[s] = g
        return grad

    # updateBetahat! (DTM.jl:244-304) with the repo's safeguards
    def update_betahat(self, cgiter, cgtol, A, wz):
        bh = self.betahat
        p_dir = np.zeros_like(bh)
        g_old = np.ones_like(bh)
        rho, f0, done = 1.0, np.inf, False
        for _ in range(cgiter):
            f_val = self._cg_objective(bh, A, wz)
            g = self._cg_gradient(bh, A, wz)
            if not np.isfinite(f0):
                f0 = f_val
            denom = max(np.sum(g_old * g_old), 1e-30)
            pr = np.clip(np.sum(g * (g - g_old)) / denom, 0.0, 1.0)
            p_dir = g + pr * p_dir
            slope = np.sum(g * p_dir)
            if slope <= 0.0:            # restart from steepest ascent
                p_dir = g.copy()
                slope = np.sum(g * g)
            r = rho
            f = self._cg_objective(bh + r * p_dir, A, wz)
            it = 0
            while (f <= f0 + 1e-4 * r * slope) and (it < 10):
                r *= 0.5
                f = self._cg_objective(bh + r * p_dir, A, wz)
                it += 1
            ok = f > f0 + 1e-4 * r * slope
            if ok and not done:
                bh = bh + r * p_dir
                f_acc = f
            else:
                f_acc = f0
            if ok and (f_acc - f0 < cgtol):
                done = True
            rho = min(r * 2.0, 1.0)
            g_old = g
            f0 = f_acc
        self.betahat = bh
        self.mbeta = self._mean_smoother(bh)

    # updateELBO! (DTM.jl:119-174)
    def update_elbo(self):
        maxl, rowsum = self._ovfl()
        mbeta0, vbeta0 = self._anchors()
        prev_m = np.concatenate([mbeta0[None], self.mbeta[:-1]], 0)
        prev_v = np.concatenate([vbeta0[None], self.vbeta[:-1]], 0)
        # Elogpbeta (DTM.jl:119-126) − Elogqbeta (DTM.jl:145-148)
        total = (-0.5 * self.T * self.K * self.V * np.log(2 * np.pi * self.S2)
                 - (0.5 / self.S2) * np.sum((self.mbeta - prev_m) ** 2
                                            + self.vbeta + prev_v))
        total += 0.5 * np.sum(np.log(2 * np.pi * np.e * self.vbeta))
        for d in range(self.M):
            t = self.sid[d]
            terms, counts = self.docs[d]
            a, g, el = self.alpha[t], self.gamma[d], self.Elogtheta[d]
            phi = self._phi(d, maxl, rowsum)
            pc = phi @ counts
            # Elogptheta (DTM.jl:128-131)
            total += (gammaln(a.sum()) - gammaln(a).sum() + (a - 1) @ el)
            # Elogpz (DTM.jl:133-137)
            total += pc @ el
            # Elogpw (DTM.jl:139-143)
            total += (np.sum(phi * self.mbeta[t][:, terms] * counts[None, :])
                      - (pc @ rowsum[t]) * np.exp(maxl[t] - self.lzeta[d])
                      - self.lzeta[d] + 1.0)
            # −Elogqtheta (DTM.jl:150-153): Dirichlet entropy
            a0 = g.sum()
            total += (gammaln(g).sum() - gammaln(a0)
                      + (a0 - self.K) * digamma(a0)
                      - np.sum((g - 1) * digamma(g)))
            # −Elogqz (DTM.jl:155-159): categorical entropies
            total += -np.sum(counts * np.sum(
                np.where(phi > 0, phi * np.log(phi), 0.0), axis=0))
        return total

    # train! (DTM.jl:311-335)
    def train(self, iters, viter=10, vtol=None, niter=1000, ntol=None,
              cgiter=20, cgtol=None):
        vtol = 1.0 / self.K**2 if vtol is None else vtol
        ntol = 1.0 / self.K**2 if ntol is None else ntol
        cgtol = 1.0 / self.T**2 if cgtol is None else cgtol
        elbos = []
        for _ in range(iters):
            maxl, rowsum = self._ovfl()
            self.estep(viter, vtol, maxl, rowsum)
            A, wz = self._cg_stats(maxl, rowsum)
            self.update_alpha(niter, ntol)
            self.update_betahat(cgiter, cgtol, A, wz)
            elbos.append(self.update_elbo())
        return elbos


def ctpf_docs_from_corpus(corp):
    return [
        (np.asarray(doc.terms, np.int64) - 1, np.asarray(doc.counts, np.float64),
         np.asarray(doc.readers, np.int64) - 1, np.asarray(doc.ratings, np.float64))
        for doc in corp.docs
    ]


def docs_from_corpus(corp):
    return [
        (np.asarray(doc.terms, np.int64) - 1, np.asarray(doc.counts, np.float64))
        for doc in corp.docs
    ]


class HMTMOracle:
    """Structured-VB hidden Markov topic model, float64, per-doc loops.

    Independent NumPy implementation of the algorithm that completes the
    reference's HMTM stub (HMTM/HMTM.jl — its mean-field phi coordinate
    was never solved): q(z) is the exact chain posterior under
    expected-log parameters, computed by per-position scaled
    forward-backward loops.  Counts are ignored — each entry of a doc's
    terms vector is one token in order (HMTM.jl:63-67).
    """

    def __init__(self, docs, V, K, beta0):
        self.docs = [np.asarray(t, np.int64) for t, _c in docs]
        self.M, self.V, self.K = len(docs), V, K
        self.eta = np.ones(K)
        self.alpha = np.ones((K, K))
        self.beta = np.asarray(beta0, np.float64).copy()
        self.tau = [np.ones(K) for _ in range(self.M)]
        self.gamma = [np.ones((K, K)) for _ in range(self.M)]
        self.elbo = 0.0

    def _tilde(self, d):
        tau, gamma = self.tau[d], self.gamma[d]
        Elogpi = digamma(tau) - digamma(tau.sum())
        Elogth = digamma(gamma) - digamma(gamma.sum(axis=0, keepdims=True))
        return np.exp(Elogpi), np.exp(Elogth)

    def _forward(self, d):
        terms = self.docs[d]
        N = len(terms)
        p0, A = self._tilde(d)
        B = self.beta[:, terms].T + EPS            # [N, K]
        a = np.zeros((N, self.K))
        c = np.zeros(N)
        logZ = 0.0
        for n in range(N):
            f = p0 * B[0] if n == 0 else B[n] * (A @ a[n - 1])
            c[n] = f.sum() + EPS
            a[n] = f / c[n]
            logZ += np.log(c[n])
        return a, c, B, A, logZ

    def _fb(self, d):
        """Chain posteriors: r [N, K], xi_sum [K, K], first-token r0."""
        terms = self.docs[d]
        N = len(terms)
        if N == 0:
            return np.zeros(self.K), np.zeros((self.K, self.K)), np.zeros((0, self.K))
        a, c, B, A, _ = self._forward(d)
        be = np.ones(self.K)
        xi_sum = np.zeros((self.K, self.K))
        r = np.zeros((N, self.K))
        for n in range(N - 1, 0, -1):
            g = B[n] * be / c[n]
            xi_sum += A * g[:, None] * a[n - 1][None, :]
            r[n] = a[n] * be
            be = A.T @ g
        r[0] = a[0] * be
        return r[0], xi_sum, r

    def doc_fixpoint(self, d, viter, vtol):
        for _ in range(viter):
            r0, xi_sum, _r = self._fb(d)
            tau_new = self.eta + r0
            gamma_new = self.alpha + xi_sum
            delta = np.linalg.norm(gamma_new - self.gamma[d])
            self.tau[d] = tau_new
            self.gamma[d] = gamma_new
            if delta < vtol:
                break

    def _dirichlet_newton(self, alpha, stat, niter, ntol):
        """Same interior-point Newton as LDAOracle.update_alpha
        (LDA.jl:97-118), on an arbitrary Dirichlet parameter."""
        alpha = alpha.copy()
        K = len(alpha)
        nu = float(K)
        for _ in range(niter):
            rho = 1.0
            a0 = alpha.sum()
            grad = nu / alpha + self.M * (digamma(a0) - digamma(alpha)) + stat
            h_inv = -1.0 / (self.M * polygamma(1, alpha) + nu / alpha**2)
            p = (grad - grad @ h_inv / (1.0 / (self.M * polygamma(1, a0)) + h_inv.sum())) * h_inv
            while np.min(alpha - rho * p) < 0:
                rho *= 0.5
            alpha = alpha - rho * p
            if (rho * np.linalg.norm(grad) < ntol) and (nu / K < ntol):
                break
            nu *= 0.5
        return alpha + EPS

    def update_eta(self, niter, ntol):
        stat = np.sum([digamma(t) - digamma(t.sum()) for t in self.tau], axis=0)
        self.eta = self._dirichlet_newton(self.eta, stat, niter, ntol)

    def update_alpha(self, niter, ntol):
        stat = np.sum(
            [digamma(g) - digamma(g.sum(axis=0, keepdims=True)) for g in self.gamma],
            axis=0,
        )
        for l in range(self.K):
            self.alpha[:, l] = self._dirichlet_newton(
                self.alpha[:, l], stat[:, l], niter, ntol)

    def update_elbo(self):
        total = 0.0
        eta, alpha = self.eta, self.alpha
        pi_const = gammaln(eta.sum()) - gammaln(eta).sum()
        th_const = np.sum(gammaln(alpha.sum(axis=0)) - gammaln(alpha).sum(axis=0))
        for d in range(self.M):
            tau, gamma = self.tau[d], self.gamma[d]
            logZ = self._forward(d)[4] if len(self.docs[d]) else 0.0
            Elogpi = digamma(tau) - digamma(tau.sum())
            Elogth = digamma(gamma) - digamma(gamma.sum(axis=0, keepdims=True))
            e_ppi = pi_const + (eta - 1) @ Elogpi
            e_pth = th_const + np.sum((alpha - 1) * Elogth)
            a0 = tau.sum()
            e_qpi = (gammaln(tau).sum() - gammaln(a0)
                     + (a0 - self.K) * digamma(a0)
                     - np.sum((tau - 1) * digamma(tau)))
            g0 = gamma.sum(axis=0)
            e_qth = np.sum(gammaln(gamma).sum(axis=0) - gammaln(g0)
                           + (g0 - self.K) * digamma(g0)
                           - np.sum((gamma - 1) * digamma(gamma), axis=0))
            total += logZ + e_ppi + e_pth + e_qpi + e_qth
        self.elbo = total
        return total

    def train(self, iters, viter=10, vtol=None, niter=1000, ntol=None):
        vtol = 1.0 / self.K**2 if vtol is None else vtol
        ntol = 1.0 / self.K**2 if ntol is None else ntol
        elbos = []
        for _ in range(iters):
            beta_temp = np.zeros((self.K, self.V))
            for d in range(self.M):
                self.doc_fixpoint(d, viter, vtol)
                _r0, _xi, r = self._fb(d)
                np.add.at(beta_temp, (slice(None), self.docs[d]), r.T)
            self.beta = beta_temp / beta_temp.sum(axis=1, keepdims=True)
            self.update_eta(niter, ntol)
            self.update_alpha(niter, ntol)
            elbos.append(self.update_elbo())
        return elbos
