"""Generic genetic-algorithm and simulated-annealing engines.

A copy of ``physher_tpu/inference/ga.py`` (numpy only). Rebuild of the reference's discrete search engines (reference: src/phyc/ga.c
— population of unsigned/bool chromosomes, roulette/CHC selection, mutation +
crossover, pthread-pool fitness evaluation at ga.c:952-1000; src/phyc/sa.c —
temperature-scheduled annealer over the same State encoding). Used by the
reference for local-clock placement, discrete-clock assignment and Q-matrix
rate-class search ("q-search", physhercmd.c:834).

Batch-first design: the population is one [P, L] integer array and fitness is
evaluated for the whole population at once — callers hand in a *batched*
fitness function (typically a likelihood over a batch of chains, one
masked encoding a chain), which replaces the reference's thread pool with the batch axis.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


@dataclass
class GAResult:
    best: np.ndarray
    best_fitness: float
    generations: int
    history: list = field(default_factory=list)


class GeneticAlgorithm:
    """Maximize ``fitness(population) -> [P] array`` over integer chromosomes.

    ``n_states`` per locus (2 = boolean indicators, e.g. local-clock
    placement; K = rate-class assignment). Selection follows the reference's
    elitist roulette (ga.c ga_default_select); ``chc=True`` switches to the
    CHC-style population-merge selection (ga.h:71-76 GA_CHC).
    """

    def __init__(self, fitness: Callable, length: int, *, n_states: int = 2,
                 pop_size: int = 50, mutation_rate: float = 0.05,
                 crossover_rate: float = 0.8, elitism: int = 2,
                 chc: bool = False, rng=None):
        self.fitness = fitness
        self.L = length
        self.K = n_states
        self.P = pop_size
        self.mutation_rate = mutation_rate
        self.crossover_rate = crossover_rate
        self.elitism = max(1, elitism)
        self.chc = chc
        self.rng = np.random.default_rng(rng)

    def _init_pop(self, init=None):
        pop = self.rng.integers(0, self.K, size=(self.P, self.L))
        if init is not None:
            pop[0] = np.asarray(init)
        return pop

    def _offspring(self, pop, fit):
        rng = self.rng
        # fitness-proportional selection on rank (robust to log-likelihood
        # scales, same intent as the reference's roulette on scaled fitness)
        order = np.argsort(fit)
        ranks = np.empty(self.P)
        ranks[order] = np.arange(1, self.P + 1)
        p = ranks / ranks.sum()
        n_children = self.P - self.elitism
        parents = rng.choice(self.P, size=(n_children, 2), p=p)
        a = pop[parents[:, 0]]
        b = pop[parents[:, 1]]
        # uniform crossover
        do_cross = rng.random(n_children) < self.crossover_rate
        mask = rng.random((n_children, self.L)) < 0.5
        children = np.where(mask & do_cross[:, None], b, a)
        # point mutation
        mut = rng.random((n_children, self.L)) < self.mutation_rate
        children = np.where(
            mut, rng.integers(0, self.K, size=(n_children, self.L)), children)
        return children

    def run(self, *, generations: int = 100, max_no_improvement: int = 20,
            init=None, verbose: bool = False) -> GAResult:
        pop = self._init_pop(init)
        fit = np.asarray(self.fitness(pop), dtype=np.float64)
        best_i = int(np.argmax(fit))
        best, best_fit = pop[best_i].copy(), float(fit[best_i])
        since = 0
        history = [best_fit]
        gen = 0
        for gen in range(generations):
            elite_idx = np.argsort(fit)[-self.elitism:]
            children = self._offspring(pop, fit)
            child_fit = np.asarray(self.fitness(children), dtype=np.float64)
            if self.chc:
                # merge parents + children, keep the best P
                allpop = np.concatenate([pop, children])
                allfit = np.concatenate([fit, child_fit])
                keep = np.argsort(allfit)[-self.P:]
                pop, fit = allpop[keep], allfit[keep]
            else:
                pop = np.concatenate([pop[elite_idx], children])
                fit = np.concatenate([fit[elite_idx], child_fit])
            gi = int(np.argmax(fit))
            if fit[gi] > best_fit + 1e-12:
                best, best_fit, since = pop[gi].copy(), float(fit[gi]), 0
            else:
                since += 1
            history.append(best_fit)
            if verbose:
                print(f"gen {gen+1} best {best_fit:.6f}")
            if since >= max_no_improvement:
                break
        return GAResult(best, best_fit, gen + 1, history)


@dataclass
class SAResult:
    best: np.ndarray
    best_energy: float
    iterations: int
    history: list = field(default_factory=list)


class SimulatedAnnealing:
    """Minimize ``energy(state)`` over an integer encoding (reference:
    src/phyc/sa.c — geometric cooling, Metropolis acceptance, max-no-
    improvement termination sa.h:33-80)."""

    def __init__(self, energy: Callable, length: int, *, n_states: int = 2,
                 initial_temp: float = 1.0, final_temp: float = 1e-3,
                 cooling: float = 0.95, steps_per_temp: int = 20,
                 mutate: Optional[Callable] = None, rng=None):
        self.energy = energy
        self.L = length
        self.K = n_states
        self.t0 = initial_temp
        self.t1 = final_temp
        self.cooling = cooling
        self.steps_per_temp = steps_per_temp
        self.mutate = mutate
        self.rng = np.random.default_rng(rng)

    def _mutate(self, state):
        if self.mutate is not None:
            return self.mutate(state, self.rng)
        s = state.copy()
        i = self.rng.integers(self.L)
        s[i] = (s[i] + self.rng.integers(1, self.K)) % self.K
        return s

    def run(self, init=None, *, max_no_improvement: int = 200,
            verbose: bool = False) -> SAResult:
        rng = self.rng
        state = (np.asarray(init).copy() if init is not None
                 else rng.integers(0, self.K, size=self.L))
        e = float(self.energy(state))
        best, best_e = state.copy(), e
        temp = self.t0
        it = 0
        since = 0
        history = [best_e]
        while temp > self.t1 and since < max_no_improvement:
            for _ in range(self.steps_per_temp):
                it += 1
                prop = self._mutate(state)
                ep = float(self.energy(prop))
                if ep < e or rng.random() < np.exp(-(ep - e) / temp):
                    state, e = prop, ep
                if e < best_e - 1e-12:
                    best, best_e, since = state.copy(), e, 0
                else:
                    since += 1
            history.append(best_e)
            temp *= self.cooling
            if verbose:
                print(f"T={temp:.4g} best {best_e:.6f}")
        return SAResult(best, best_e, it, history)
