"""The PyTorch port's public surface against the JAX package's, by import
alone: every public class and function of every JAX module has its
counterpart in the port's module of the same name, every public member of
such a class exists on the port's class (inherited members count), and
every keyword of every public function and method is accepted by the
port's counterpart (a ``**kwargs`` accepts all). Anything else fails the
tests, unless it stands on the exclusion lists below, each entry with its
reason and, where there is one, its counterpart (the lists match
``ROADMAP.md``'s "Not ported"). An entry that the port no longer lacks
fails too, so that the lists stay exact.

What a module, a class or a function holds is read from the objects that
its own module defines (``vars`` filtered by ``__module__``), never from
``dir()`` of a module, which other tests' imports can change.
"""

import functools
import importlib
import importlib.util
import inspect
import pkgutil

import desilike_tpu


PORT = 'desilike_tpu_torch'

MODULE_EXCLUSIONS = {
    'desilike_tpu.jax': 'the shims for reference desilike\'s JAX idioms (jit, vmap, numpy-on-jnp): nothing to shim '
                        'in PyTorch',
    'desilike_tpu.ops.pallas_kernels': 'the TPU kernel (clenshaw_pallas); its counterparts are the CUDA kernels '
                                       'of desilike_tpu_torch.ops.cuda_kernels (clenshaw, clenshaw_coeff_grad)',
}

MEMBER_EXCLUSIONS = {
    'desilike_tpu.config.asarray': 'TPU-only: device placement of the JAX backend; the port takes tensors on the '
                                   'caller\'s device',
    'desilike_tpu.config.nparray': 'TPU-only: the host copy of a JAX array; the port\'s is Tensor.cpu().numpy()',
    'desilike_tpu.config.host_eval': 'TPU-only: pins initialization to the CPU backend; the port initializes in '
                                     'float64 numpy on the host by construction',
    'desilike_tpu.config.loop_matmul_precision': 'TPU-only: the MXU pass count of the loop einsums; the port keeps '
                                                 'float32 matmuls full precision (config.py, no TF32)',
    'desilike_tpu.parameters.prior.Prior.ppf_jax': 'the jnp prior transform; counterpart Prior.ppf_torch',
    'desilike_tpu.likelihoods.cmb.hillipop.cib_ratio_jnp': 'replaced by the foreground tables folded at build '
                                                           '(likelihoods/cmb/hillipop.py)',
    'desilike_tpu.likelihoods.cmb.hillipop.dust_ratio_jnp': 'replaced by the foreground tables folded at build '
                                                            '(likelihoods/cmb/hillipop.py)',
}

CLASS_MEMBER_EXCLUSIONS = {
    'tree_flatten': 'the JAX pytree protocol',
    'tree_unflatten': 'the JAX pytree protocol',
}

KEYWORD_EXCLUSIONS = {
    'key': 'a jax.random key; the port draws from a torch.Generator (generator=)',
    'rng': 'a jax.random key; the port draws from a torch.Generator (generator=)',
    'precision': 'the XLA matmul precision; the port keeps float32 matmuls full precision',
}

SIGNATURE_EXCLUSIONS = {
    'desilike_tpu.ops.tns.TNSCorrections.tables': 'the port takes pk sampled at the static points (pk_q, pk_k, '
                                                  'pk_y) and the kernels, so that the lookup is one Clenshaw launch '
                                                  'with a shared x',
    'desilike_tpu.likelihoods.cmb.lollipop.eigh2': 'the port takes the entries (a, b, c), elementwise over the '
                                                   '(B, nbins) batch, not one 2 x 2 matrix under vmap',
    'desilike_tpu.likelihoods.cmb.lollipop.matfunc2': 'the port takes the entries (a, b, c, fn), elementwise over '
                                                      'the (B, nbins) batch',
    'desilike_tpu.likelihoods.cmb.act_dr6_lensing.corrected_clkk': 'the port reads the correction tables through '
                                                                   'the likelihood\'s const cache (like=), not from '
                                                                   'a dict of arrays',
}


def port_name(name):
    return PORT + name[len('desilike_tpu'):]


def own_objects(module):
    """The public classes and functions ``module`` defines itself."""
    return {name: obj for name, obj in vars(module).items()
            if not name.startswith('_') and (inspect.isclass(obj) or inspect.isfunction(obj))
            and getattr(obj, '__module__', None) == module.__name__}


def class_members(cls):
    """The public members of ``cls`` and of its bases defined in the JAX
    package (name -> the object in the class body), and its constructor and
    ``__call__`` where the package defines them."""
    members = {}
    for klass in reversed(cls.__mro__):
        if not klass.__module__.startswith('desilike_tpu'):
            continue
        for name, obj in vars(klass).items():
            if not name.startswith('_') or name in ('__init__', '__call__'):
                members[name] = obj
    return members


@functools.lru_cache()
def surface():
    """(missing modules, [(JAX module name, JAX module, port module)])."""
    missing, pairs = [], []
    for info in pkgutil.walk_packages(desilike_tpu.__path__, 'desilike_tpu.'):
        if info.name in MODULE_EXCLUSIONS or info.name.startswith('desilike_tpu.jax.'):
            continue
        try:
            port = importlib.import_module(port_name(info.name))
        except ImportError:
            missing.append(info.name)
            continue
        pairs.append((info.name, importlib.import_module(info.name), port))
    return missing, pairs


def test_class_member_names():
    """Every module, public class and function, and public class member of
    the JAX package has its counterpart, but for the stated exclusions."""
    missing, pairs = surface()
    missing, excluded = list(missing), set()
    for name, module, port in pairs:
        for objname, obj in own_objects(module).items():
            label = '{}.{}'.format(name, objname)
            if not hasattr(port, objname):
                if label in MEMBER_EXCLUSIONS:
                    excluded.add(label)
                else:
                    missing.append(label)
                continue
            if not inspect.isclass(obj):
                continue
            counterpart = getattr(port, objname)
            for member in class_members(obj):
                if member.startswith('_') or hasattr(counterpart, member):
                    continue
                label = '{}.{}.{}'.format(name, objname, member)
                if label in MEMBER_EXCLUSIONS or member in CLASS_MEMBER_EXCLUSIONS:
                    excluded.add(label if label in MEMBER_EXCLUSIONS else member)
                else:
                    missing.append(label)
    assert not missing, sorted(missing)
    for name in MODULE_EXCLUSIONS:
        assert importlib.util.find_spec(name) is not None and importlib.util.find_spec(port_name(name)) is None, name
    stale = (set(MEMBER_EXCLUSIONS) | set(CLASS_MEMBER_EXCLUSIONS)) - excluded
    assert not stale, sorted(stale)


def keywords(fn):
    """The names ``fn`` takes as keywords (None for ``**kwargs``: any), or
    None where it has no signature to read."""
    try:
        parameters = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return None
    if any(p.kind == p.VAR_KEYWORD for p in parameters):
        return None
    return {p.name for p in parameters if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}


def callables(name, module, port):
    """(label, JAX function, port counterpart) of every public function and
    method of ``module`` that the port has."""
    for objname, obj in own_objects(module).items():
        counterpart = getattr(port, objname, None)
        if counterpart is None:
            continue
        label = '{}.{}'.format(name, objname)
        if inspect.isfunction(obj):
            yield label, obj, counterpart
            continue
        for member, value in class_members(obj).items():
            if isinstance(value, (staticmethod, classmethod)):
                value = value.__func__
            if inspect.isfunction(value) and hasattr(counterpart, member):
                yield '{}.{}'.format(label, member), value, getattr(counterpart, member)


def test_signature_keywords():
    """Every keyword of every public function and method of the JAX package
    is accepted by the port's counterpart, but for the stated exclusions."""
    _, pairs = surface()
    missing, excluded = [], set()
    for name, module, port in pairs:
        for label, fn, counterpart in callables(name, module, port):
            accepted = keywords(counterpart)
            if accepted is None:
                continue
            expected = {p.name for p in inspect.signature(fn).parameters.values()
                        if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)} - {'self', 'cls'}
            lacking = expected - accepted
            if not lacking:
                continue
            if label in SIGNATURE_EXCLUSIONS:
                excluded.add(label)
                continue
            for keyword in sorted(lacking):
                if keyword in KEYWORD_EXCLUSIONS:
                    excluded.add(keyword)
                else:
                    missing.append('{}({})'.format(label, keyword))
    assert not missing, sorted(missing)
    stale = (set(SIGNATURE_EXCLUSIONS) | set(KEYWORD_EXCLUSIONS)) - excluded
    assert not stale, sorted(stale)
