// The native record core and whole-step driver of the lazy window
// (paddle_tpu_torch/_core/lazy.py), as a CPython extension.
//
// The window's Python prong records each eager op through
// CaptureContext.record; once a sealed segment's op stream has proved that
// it repeats, later records replay the retained skeleton position by
// position (CaptureContext._record_fast). This module does the same work
// in C, written against the port's classes (LazyRef, Tensor, _PendingOp):
//
//   attrs_key(attrs)   -- the sorted (name, constant key) tuple of an op's
//       attrs, built as lazy._const_key builds it and interned; None when a
//       value is outside the primitive set (the caller builds it in Python).
//   sig_entry(entry)   -- interns one segment-signature entry in the pool
//       lazy.py keeps (lazy._SIG_ENTRY_INTERN, handed over by bind_types),
//       with the Python pool's rule: past 65536 entries it is cleared.
//   meta_get / meta_put / meta_clear -- the record-time metadata cache,
//       keyed by op name, the function's id, the attrs key, the constants'
//       keys, the inputs' interned (shape, dtype, device, requires_grad)
//       atoms, the grad mode and the AMP key, as lazy._out_metas keys its
//       Python cache. Past FLAGS_executable_cache_capacity entries (65536
//       when the flag is 0) it is cleared.
//   bind_types(...)    -- registers the classes and handles the replay
//       reads and makes.
//   skel_record(ctx, ctups, in_sig, name, fn, inputs, attrs) -- one record
//       replayed against the skeleton op at ctx._skel_pos: the op, its
//       function and attrs, its constants, its input wiring, the grad mode
//       and the AMP state must match, and a fresh external input must have
//       the sealed segment's metadata at its index. Returns the outputs,
//       None on a mismatch, or NotImplemented where C cannot judge (the
//       Python fast path then decides). Nothing is changed unless the whole
//       op matched.
//   bind_drive(...) / drive_record(drv, name, fn, inputs, attrs) -- the
//       whole-step driver: once a promoted step plan is armed in
//       lazy._DRIVE_CELL, dispatch.apply hands each op to one call that
//       checks the thread, the skeleton generation and the cursor, replays
//       the op, advances the context's cursor and counters as skel_record
//       does and returns its outputs. It retires itself (empties the cell)
//       at the plan's end, at the segment cap (then flushes) and on any
//       mismatch.
//
// A Python scalar operand is recorded as itself (a constant of the op), as
// the port's full record path records it: there is no operand coercion.
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>

#include <algorithm>
#include <cstring>
#include <utility>
#include <vector>

namespace {

constexpr Py_ssize_t kMetaCap = 65536;
constexpr Py_ssize_t kEntryCap = 65536;
constexpr Py_ssize_t kAttrsCap = 8192;
constexpr Py_ssize_t kCtupSize = 11;
constexpr Py_ssize_t kMaxInputs = 64;

// ---- bound classes and handles (bind_types)
PyObject* g_lazyref_t = nullptr;   // lazy.LazyRef
PyObject* g_tensor_t = nullptr;    // tensor.Tensor
PyObject* g_pending_t = nullptr;   // lazy._PendingOp
PyObject* g_torch_t = nullptr;     // torch.Tensor
PyObject* g_dtype_t = nullptr;     // torch.dtype
PyObject* g_ige = nullptr;         // torch.is_grad_enabled
PyObject* g_sig_pool = nullptr;    // lazy._SIG_ENTRY_INTERN
PyObject* g_dispatch = nullptr;    // _core.dispatch (module)
PyObject* g_amp_tls = nullptr;     // amp.auto_cast._STATE
PyObject* g_state_key = nullptr;   // amp.auto_cast.state_key
PyObject* g_lazy_mod = nullptr;    // _core.lazy (module)
PyObject* g_payload_descr = nullptr;  // Tensor's _payload member

// ---- the driver's handles (bind_drive)
PyObject* g_drive_t = nullptr;     // lazy._DriveState
PyObject* g_gen_cell = nullptr;    // lazy._FAST_GEN_CELL
PyObject* g_drive_cell = nullptr;  // lazy._DRIVE_CELL
bool g_drive_ok = false;

// ---- module-lifetime pools
PyObject* g_meta_cache = nullptr;  // metadata key -> (fn weakref, result)
PyObject* g_atoms = nullptr;       // (shape, dtype, device, rg) -> itself
PyObject* g_attrs_pool = nullptr;  // attrs key -> itself
PyObject* g_one = nullptr;

PyObject *s_payload, *s_shape, *s_dtype, *s_device, *s_requires_grad,
    *s_skel_pos, *s_fast_ops, *s_ops_recorded, *s_FAST_OPS, *s_amp, *s_key,
    *s_AMP_HOOK, *s_STATIC_HOOK, *s_flush, *s_segment_cap, *s_O0, *s_f,
    *s_NoneType, *s_bool, *s_int, *s_str, *s_bytes, *s_tuple, *s_list,
    *s_dtype_tag, *s_in, *s_op;

// __slots__ member offsets of the bound classes (-1: use getattr/setattr)
struct Off {
  Py_ssize_t t_payload = -1, t_name = -1, t_persistable = -1;
  Py_ssize_t r_ctx = -1, r_op_idx = -1, r_slot = -1, r_shape = -1,
             r_dtype = -1, r_device = -1, r_requires_grad = -1,
             r_trefs = -1;
  Py_ssize_t p_name = -1, p_fn = -1, p_attrs = -1, p_kvals = -1,
             p_wiring = -1, p_out_refs = -1, p_n_outs = -1, p_multi = -1,
             p_grad = -1, p_amp = -1, p_amp_key = -1, p_req = -1;
};
Off g_off;

struct DriveOff {
  Py_ssize_t ctx = -1, ctups = -1, in_sig = -1, in_ids = -1,
             in_tensors = -1, in_vals = -1, in_pins = -1, pending = -1,
             sig_ops = -1, pinned = -1, pos = -1, gen = -1, cap = -1,
             tid = -1;
};
DriveOff g_d;

Py_ssize_t slot_offset(PyObject* type, const char* name) {
  PyObject* d = PyObject_GetAttrString(type, name);
  if (!d) {
    PyErr_Clear();
    return -1;
  }
  Py_ssize_t off = -1;
  if (Py_TYPE(d) == &PyMemberDescr_Type) {
    PyMemberDef* m = ((PyMemberDescrObject*)d)->d_member;
    if (m && m->type == T_OBJECT_EX && !(m->flags & READONLY)) {
      off = m->offset;
    }
  }
  Py_DECREF(d);
  return off;
}

// the object in a slot (borrowed, may be null when unset)
inline PyObject* slot_at(PyObject* obj, Py_ssize_t off) {
  return *(PyObject**)((char*)obj + off);
}

// store into a slot of an object made by tp_alloc from the bound class
bool set_slot(PyObject* obj, Py_ssize_t off, const char* name,
              PyObject* v) {
  if (off >= 0) {
    Py_INCREF(v);
    PyObject* old = slot_at(obj, off);
    *(PyObject**)((char*)obj + off) = v;
    Py_XDECREF(old);
    return true;
  }
  return PyObject_SetAttrString(obj, name, v) == 0;
}

// a Tensor's payload (NEW reference): the slot where the class's _payload
// is the Tensor's own member (a subclass such as Parameter inherits it)
PyObject* payload_of(PyObject* t) {
  if (g_off.t_payload >= 0 &&
      _PyType_Lookup(Py_TYPE(t), s_payload) == g_payload_descr) {
    PyObject* v = slot_at(t, g_off.t_payload);
    if (v) {
      Py_INCREF(v);
      return v;
    }
  }
  return PyObject_GetAttr(t, s_payload);
}

inline bool is_tensor(PyObject* x) {
  return PyObject_TypeCheck(x, (PyTypeObject*)g_tensor_t);
}

inline bool is_torch(PyObject* x) {
  return PyObject_TypeCheck(x, (PyTypeObject*)g_torch_t);
}

PyObject* pool_intern(PyObject* pool, PyObject* obj, Py_ssize_t cap) {
  PyObject* found = PyDict_GetItemWithError(pool, obj);
  if (found) {
    Py_INCREF(found);
    return found;
  }
  if (PyErr_Occurred()) return nullptr;
  if (PyDict_Size(pool) > cap) PyDict_Clear(pool);
  if (PyDict_SetItem(pool, obj, obj) < 0) return nullptr;
  Py_INCREF(obj);
  return obj;
}

// ------------------------------------------------------------- keys

// lazy._const_key of a primitive value, a torch.dtype, or a tuple or list
// of those (depth < 4). NEW reference; nullptr without an error set when
// the value is of another kind (the caller builds the key in Python).
PyObject* const_key(PyObject* v, int depth) {
  PyObject* tag = nullptr;
  PyTypeObject* tp = Py_TYPE(v);
  if (tp == &PyFloat_Type) {
    double d = PyFloat_AS_DOUBLE(v);
    unsigned char buf[8];
    if (PyFloat_Pack8(d, (char*)buf, 1) < 0) return nullptr;
    PyObject* b = PyBytes_FromStringAndSize((const char*)buf, 8);
    if (!b) return nullptr;
    PyObject* k = PyTuple_Pack(2, s_f, b);
    Py_DECREF(b);
    return k;
  }
  if (v == Py_None) tag = s_NoneType;
  else if (tp == &PyBool_Type) tag = s_bool;
  else if (tp == &PyLong_Type) tag = s_int;
  else if (tp == &PyUnicode_Type) tag = s_str;
  else if (tp == &PyBytes_Type) tag = s_bytes;
  if (tag) return PyTuple_Pack(2, tag, v);
  if (g_dtype_t && tp == (PyTypeObject*)g_dtype_t) {
    return PyTuple_Pack(2, s_dtype_tag, v);
  }
  if ((tp == &PyTuple_Type || tp == &PyList_Type) && depth < 4) {
    PyObject* seq = PySequence_Fast(v, "");
    if (!seq) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject* parts = PyTuple_New(n);
    if (!parts) {
      Py_DECREF(seq);
      return nullptr;
    }
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* p = const_key(PySequence_Fast_GET_ITEM(seq, i), depth + 1);
      if (!p) {
        Py_DECREF(parts);
        Py_DECREF(seq);
        return nullptr;
      }
      PyTuple_SET_ITEM(parts, i, p);
    }
    Py_DECREF(seq);
    PyObject* k =
        PyTuple_Pack(2, tp == &PyTuple_Type ? s_tuple : s_list, parts);
    Py_DECREF(parts);
    return k;
  }
  return nullptr;
}

// attrs_key(attrs) -> interned ((name, const key), ...) sorted by name, or
// None when a value needs lazy._const_key's Python cases
PyObject* attrs_key(PyObject*, PyObject* attrs) {
  if (!PyDict_Check(attrs)) {
    PyErr_SetString(PyExc_TypeError, "attrs_key expects a dict");
    return nullptr;
  }
  std::vector<std::pair<PyObject*, PyObject*>> items;  // (name, key) owned
  items.reserve(PyDict_GET_SIZE(attrs));
  PyObject *k, *v;
  Py_ssize_t pos = 0;
  bool punt = false;
  while (PyDict_Next(attrs, &pos, &k, &v)) {
    if (!PyUnicode_CheckExact(k)) {
      punt = true;
      break;
    }
    PyObject* ck = const_key(v, 0);
    if (!ck) {
      punt = true;
      break;
    }
    items.emplace_back(k, ck);
  }
  if (punt) {
    for (auto& it : items) Py_DECREF(it.second);
    if (PyErr_Occurred()) return nullptr;
    Py_RETURN_NONE;
  }
  std::sort(items.begin(), items.end(),
            [](const std::pair<PyObject*, PyObject*>& a,
               const std::pair<PyObject*, PyObject*>& b) {
              return PyUnicode_Compare(a.first, b.first) < 0;
            });
  PyObject* key = PyTuple_New((Py_ssize_t)items.size());
  bool ok = key != nullptr;
  for (size_t i = 0; i < items.size(); ++i) {
    PyObject* pair = ok ? PyTuple_Pack(2, items[i].first, items[i].second)
                        : nullptr;
    Py_DECREF(items[i].second);
    if (!pair) {
      ok = false;
      continue;
    }
    PyTuple_SET_ITEM(key, (Py_ssize_t)i, pair);
  }
  if (!ok) {
    Py_XDECREF(key);
    return nullptr;
  }
  PyObject* interned = pool_intern(g_attrs_pool, key, kAttrsCap);
  Py_DECREF(key);
  return interned;
}

// sig_entry(entry) -> the pool's entry equal to it (lazy._intern_sig_entry)
PyObject* sig_entry(PyObject*, PyObject* entry) {
  if (!g_sig_pool) {
    PyErr_SetString(PyExc_RuntimeError, "bind_types was not called");
    return nullptr;
  }
  PyObject* e = PyDict_SetDefault(g_sig_pool, entry, entry);  // borrowed
  if (!e) return nullptr;
  Py_INCREF(e);
  if (PyDict_GET_SIZE(g_sig_pool) > kEntryCap) PyDict_Clear(g_sig_pool);
  return e;
}

// (name, id(fn), akey, ckeys, (atom | None, ...), grad, amp_key): NEW ref
PyObject* meta_key(PyObject* const* a) {
  PyObject* metas = a[4];
  PyObject* seq = PySequence_Fast(metas, "metas must be a sequence");
  if (!seq) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  PyObject* atoms = PyTuple_New(n);
  if (!atoms) {
    Py_DECREF(seq);
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* m = PySequence_Fast_GET_ITEM(seq, i);
    PyObject* atom = m == Py_None ? (Py_INCREF(Py_None), Py_None)
                                  : pool_intern(g_atoms, m, kMetaCap);
    if (!atom) {
      Py_DECREF(atoms);
      Py_DECREF(seq);
      return nullptr;
    }
    PyTuple_SET_ITEM(atoms, i, atom);
  }
  Py_DECREF(seq);
  PyObject* fid = PyLong_FromVoidPtr(a[1]);
  if (!fid) {
    Py_DECREF(atoms);
    return nullptr;
  }
  PyObject* key = PyTuple_Pack(7, a[0], fid, a[2], a[3], atoms, a[5], a[6]);
  Py_DECREF(fid);
  Py_DECREF(atoms);
  return key;
}

// meta_get(name, fn, akey, ckeys, metas, grad, amp_key) -> result | None
PyObject* meta_get(PyObject*, PyObject* const* a, Py_ssize_t n) {
  if (n != 7) {
    PyErr_SetString(PyExc_TypeError, "meta_get expects 7 arguments");
    return nullptr;
  }
  PyObject* key = meta_key(a);
  if (!key) return nullptr;
  PyObject* hit = PyDict_GetItemWithError(g_meta_cache, key);  // borrowed
  Py_DECREF(key);
  if (!hit) {
    if (PyErr_Occurred()) return nullptr;
    Py_RETURN_NONE;
  }
  // (weakref to fn or None, result): a dead or reused id is a miss
  PyObject* ref = PyTuple_GET_ITEM(hit, 0);
  if (ref != Py_None && PyWeakref_GetObject(ref) != a[1]) Py_RETURN_NONE;
  PyObject* res = PyTuple_GET_ITEM(hit, 1);
  Py_INCREF(res);
  return res;
}

// meta_put(name, fn, akey, ckeys, metas, grad, amp_key, result, capacity)
PyObject* meta_put(PyObject*, PyObject* const* a, Py_ssize_t n) {
  if (n != 9) {
    PyErr_SetString(PyExc_TypeError, "meta_put expects 9 arguments");
    return nullptr;
  }
  Py_ssize_t cap = PyLong_AsSsize_t(a[8]);
  if (cap == -1 && PyErr_Occurred()) return nullptr;
  if (cap <= 0 || cap > kMetaCap) cap = kMetaCap;
  PyObject* key = meta_key(a);
  if (!key) return nullptr;
  PyObject* ref = PyWeakref_NewRef(a[1], nullptr);
  if (!ref) {
    PyErr_Clear();  // a method descriptor: as long-lived as torch
    ref = Py_None;
    Py_INCREF(ref);
  }
  PyObject* val = PyTuple_Pack(2, ref, a[7]);
  Py_DECREF(ref);
  if (!val) {
    Py_DECREF(key);
    return nullptr;
  }
  if (PyDict_GET_SIZE(g_meta_cache) >= cap) PyDict_Clear(g_meta_cache);
  int rc = PyDict_SetItem(g_meta_cache, key, val);
  Py_DECREF(key);
  Py_DECREF(val);
  if (rc < 0) return nullptr;
  Py_RETURN_NONE;
}

PyObject* meta_clear(PyObject*, PyObject*) {
  PyDict_Clear(g_meta_cache);
  PyDict_Clear(g_atoms);
  Py_RETURN_NONE;
}

PyObject* intern_sizes(PyObject*, PyObject*) {
  return Py_BuildValue("{s:n,s:n,s:n,s:n}", "meta_cache",
                       PyDict_GET_SIZE(g_meta_cache), "atoms",
                       PyDict_GET_SIZE(g_atoms), "attrs",
                       PyDict_GET_SIZE(g_attrs_pool), "sig_entry",
                       g_sig_pool ? PyDict_GET_SIZE(g_sig_pool) : 0);
}

// ---------------------------------------------------------- binding

void set_ref(PyObject** slot, PyObject* v) {
  Py_XINCREF(v);
  Py_XDECREF(*slot);
  *slot = v;
}

// bind_types(LazyRef, Tensor, _PendingOp, torch.Tensor, torch.dtype,
//            torch.is_grad_enabled, sig_pool, dispatch, amp_state,
//            state_key, lazy)
PyObject* bind_types(PyObject*, PyObject* args) {
  PyObject *lr, *tt, *po, *torch_t, *dtype_t, *ige, *pool, *disp, *amp,
      *skey, *lazy_mod;
  if (!PyArg_ParseTuple(args, "O!O!O!O!O!OO!OOOO", &PyType_Type, &lr,
                        &PyType_Type, &tt, &PyType_Type, &po, &PyType_Type,
                        &torch_t, &PyType_Type, &dtype_t, &ige,
                        &PyDict_Type, &pool, &disp, &amp, &skey,
                        &lazy_mod)) {
    return nullptr;
  }
  set_ref(&g_lazyref_t, lr);
  set_ref(&g_tensor_t, tt);
  set_ref(&g_pending_t, po);
  set_ref(&g_torch_t, torch_t);
  set_ref(&g_dtype_t, dtype_t);
  set_ref(&g_ige, ige);
  set_ref(&g_sig_pool, pool);
  set_ref(&g_dispatch, disp);
  set_ref(&g_amp_tls, amp);
  set_ref(&g_state_key, skey);
  set_ref(&g_lazy_mod, lazy_mod);
  g_off.t_payload = slot_offset(tt, "_payload");
  g_off.t_name = slot_offset(tt, "name");
  g_off.t_persistable = slot_offset(tt, "persistable");
  PyObject* d = _PyType_Lookup((PyTypeObject*)tt, s_payload);
  set_ref(&g_payload_descr, d);
  g_off.r_ctx = slot_offset(lr, "ctx");
  g_off.r_op_idx = slot_offset(lr, "op_idx");
  g_off.r_slot = slot_offset(lr, "slot");
  g_off.r_shape = slot_offset(lr, "shape");
  g_off.r_dtype = slot_offset(lr, "dtype");
  g_off.r_device = slot_offset(lr, "device");
  g_off.r_requires_grad = slot_offset(lr, "requires_grad");
  g_off.r_trefs = slot_offset(lr, "trefs");
  g_off.p_name = slot_offset(po, "name");
  g_off.p_fn = slot_offset(po, "fn");
  g_off.p_attrs = slot_offset(po, "attrs");
  g_off.p_kvals = slot_offset(po, "kvals");
  g_off.p_wiring = slot_offset(po, "wiring");
  g_off.p_out_refs = slot_offset(po, "out_refs");
  g_off.p_n_outs = slot_offset(po, "n_outs");
  g_off.p_multi = slot_offset(po, "multi");
  g_off.p_grad = slot_offset(po, "grad");
  g_off.p_amp = slot_offset(po, "amp");
  g_off.p_amp_key = slot_offset(po, "amp_key");
  g_off.p_req = slot_offset(po, "req");
  Py_RETURN_NONE;
}

// ------------------------------------------------------------ replay

PyObject* miss() { Py_RETURN_NONE; }
PyObject* punt() {
  PyErr_Clear();
  Py_RETURN_NOTIMPLEMENTED;
}

// a module attribute (borrowed, null when absent)
inline PyObject* module_attr(PyObject* mod, PyObject* name) {
  return PyDict_GetItem(PyModule_GetDict(mod), name);
}

// lazy._amp_now(): (state, key) of the calling thread's AMP scope, or
// (None, None). NEW references in *state and *key; false on an error.
bool amp_now(PyObject** state, PyObject** key) {
  *state = *key = nullptr;
  PyObject* hook = module_attr(g_dispatch, s_AMP_HOOK);
  if (!hook || hook == Py_None) {
    *state = Py_NewRef(Py_None);
    *key = Py_NewRef(Py_None);
    return true;
  }
  PyObject* st = PyObject_GetAttr(g_amp_tls, s_amp);
  if (!st) {
    if (!PyErr_ExceptionMatches(PyExc_AttributeError)) return false;
    PyErr_Clear();
    st = Py_NewRef(Py_None);
  }
  bool off = st == Py_None;
  if (!off && PyTuple_Check(st) && PyTuple_GET_SIZE(st) > 0) {
    PyObject* level = PyTuple_GET_ITEM(st, 0);
    int eq = PyObject_RichCompareBool(level, s_O0, Py_EQ);
    if (eq < 0) {
      Py_DECREF(st);
      return false;
    }
    off = eq == 1;
  }
  if (off) {
    Py_DECREF(st);
    *state = Py_NewRef(Py_None);
    *key = Py_NewRef(Py_None);
    return true;
  }
  // state_key()'s memo: (state, key) while the scope's state is the same
  PyObject* memo = PyObject_GetAttr(g_amp_tls, s_key);
  if (memo && PyTuple_Check(memo) && PyTuple_GET_SIZE(memo) == 2 &&
      PyTuple_GET_ITEM(memo, 0) == st) {
    *key = Py_NewRef(PyTuple_GET_ITEM(memo, 1));
  }
  Py_XDECREF(memo);
  PyErr_Clear();
  if (!*key) {
    *key = PyObject_CallNoArgs(g_state_key);
    if (!*key) {
      Py_DECREF(st);
      return false;
    }
  }
  *state = st;
  return true;
}

// the wiring kinds of lazy.py: ("in", i) or ("op", j, s)
inline bool wire_is(PyObject* w, Py_ssize_t size, PyObject* tag) {
  if (!PyTuple_Check(w) || PyTuple_GET_SIZE(w) != size) return false;
  PyObject* t = PyTuple_GET_ITEM(w, 0);
  return t == tag || (PyUnicode_Check(t) && PyUnicode_Compare(t, tag) == 0);
}

inline int eq_obj(PyObject* a, PyObject* b) {
  return a == b ? 1 : PyObject_RichCompareBool(a, b, Py_EQ);
}

// lazy._meta_of(p) == sig: 1 equal, 0 not, -1 error
int meta_equals(PyObject* p, PyObject* sig) {
  if (!PyTuple_Check(sig) || PyTuple_GET_SIZE(sig) != 4) return 0;
  PyObject* names[3] = {s_shape, s_dtype, s_device};
  for (int i = 0; i < 3; ++i) {
    PyObject* v = PyObject_GetAttr(p, names[i]);
    if (!v) return -1;
    int eq = eq_obj(v, PyTuple_GET_ITEM(sig, i));
    Py_DECREF(v);
    if (eq != 1) return eq;
  }
  PyObject* rg = PyObject_GetAttr(p, s_requires_grad);
  if (!rg) return -1;
  int a = PyObject_IsTrue(rg);
  Py_DECREF(rg);
  int b = PyObject_IsTrue(PyTuple_GET_ITEM(sig, 3));
  if (a < 0 || b < 0) return -1;
  return a == b;
}

// lazy._consts_equal for one position: 1 equal, 0 not, 2 undecided here
int const_equal(PyObject* x, PyObject* y) {
  if (x == y) return 1;
  PyTypeObject* tx = Py_TYPE(x);
  if (tx != Py_TYPE(y)) return 0;
  if (tx == &PyFloat_Type) {
    double a = PyFloat_AS_DOUBLE(x), b = PyFloat_AS_DOUBLE(y);
    return std::memcmp(&a, &b, sizeof(double)) == 0;
  }
  if (tx == &PyLong_Type || tx == &PyBool_Type || tx == &PyUnicode_Type) {
    int eq = PyObject_RichCompareBool(x, y, Py_EQ);
    return eq < 0 ? 2 : eq;
  }
  return 2;
}

struct Seg {  // the context's current segment lists (borrowed)
  PyObject *in_ids, *in_tensors, *in_vals, *in_pins, *pending, *sig_ops;
  bool pinned;
};

// one record judged against skeleton op `ctup` and, when it matches,
// committed: fresh external inputs registered, the LazyRef outputs, their
// Tensors and the _PendingOp made and appended. Returns the user-facing
// outputs, or miss() / punt() / nullptr; nothing is changed unless the
// whole op matched.
// ctup = (name, fn, attrs, kvals, wiring, out_metas, multi, grad, amp_key,
//         req, entry)
PyObject* replay_one(PyObject* ctx, PyObject* ctup, PyObject* in_sig,
                     PyObject* name, PyObject* fn, PyObject* const* xs,
                     Py_ssize_t n_in, PyObject* attrs, const Seg& seg) {
  PyObject* s_name = PyTuple_GET_ITEM(ctup, 0);
  PyObject* s_fn = PyTuple_GET_ITEM(ctup, 1);
  PyObject* s_attrs = PyTuple_GET_ITEM(ctup, 2);
  PyObject* s_kvals = PyTuple_GET_ITEM(ctup, 3);
  PyObject* wiring = PyTuple_GET_ITEM(ctup, 4);
  PyObject* out_metas = PyTuple_GET_ITEM(ctup, 5);
  PyObject* multi = PyTuple_GET_ITEM(ctup, 6);
  PyObject* s_grad = PyTuple_GET_ITEM(ctup, 7);
  PyObject* s_amp_key = PyTuple_GET_ITEM(ctup, 8);
  PyObject* s_req = PyTuple_GET_ITEM(ctup, 9);
  PyObject* entry = PyTuple_GET_ITEM(ctup, 10);

  if (s_fn != fn) return miss();
  if (s_name != name) {
    int eq = PyObject_RichCompareBool(s_name, name, Py_EQ);
    if (eq != 1) return eq < 0 ? punt() : miss();
  }
  if (!PyTuple_Check(wiring) || !PyTuple_Check(s_kvals) ||
      !PyTuple_Check(out_metas)) {
    return punt();
  }
  if (PyTuple_GET_SIZE(wiring) != n_in || PyTuple_GET_SIZE(s_kvals) != n_in) {
    return miss();
  }
  if (!PyDict_Check(attrs) || !PyDict_Check(s_attrs)) return punt();
  if (PyDict_GET_SIZE(attrs) || PyDict_GET_SIZE(s_attrs)) {
    // the Python prong's `attrs != s.attrs`; a comparison that raises is
    // a mismatch there too
    int eq = PyObject_RichCompareBool(attrs, s_attrs, Py_EQ);
    if (eq != 1) {
      PyErr_Clear();
      return miss();
    }
  }
  PyObject* grad = PyObject_CallNoArgs(g_ige);
  if (!grad) return punt();
  Py_DECREF(grad);  // Py_True / Py_False, immortal
  if (grad != s_grad) return miss();
  PyObject *amp, *amp_key;
  if (!amp_now(&amp, &amp_key)) return punt();
  int keq = eq_obj(amp_key, s_amp_key);
  if (keq != 1) {
    Py_DECREF(amp);
    Py_DECREF(amp_key);
    return keq < 0 ? punt() : miss();
  }

  Py_ssize_t n_reg = PyList_GET_SIZE(seg.in_vals);
  std::vector<std::pair<PyObject*, PyObject*>> new_ext;  // (x, p) owned p
  PyObject* kvals = PyList_New(n_in);
  if (!kvals) {
    Py_DECREF(amp);
    Py_DECREF(amp_key);
    return nullptr;
  }
  bool req = false;
  int verdict = 1;  // 1 match, 0 miss, 2 punt, -1 error
  for (Py_ssize_t i = 0; verdict == 1 && i < n_in; ++i) {
    PyObject* x = xs[i];
    PyObject* w = PyTuple_GET_ITEM(wiring, i);
    if (w == Py_None) {
      if (is_tensor(x) || is_torch(x)) {
        verdict = 0;
        break;
      }
      int c = const_equal(x, PyTuple_GET_ITEM(s_kvals, i));
      if (c != 1) {
        verdict = c == 0 ? 0 : 2;
        break;
      }
      PyList_SET_ITEM(kvals, i, Py_NewRef(x));
      continue;
    }
    PyList_SET_ITEM(kvals, i, Py_NewRef(Py_None));
    PyObject* p;
    if (is_tensor(x)) {
      p = payload_of(x);
      if (!p) {
        verdict = 2;
        break;
      }
      if (Py_TYPE(p) == (PyTypeObject*)g_lazyref_t) {
        PyObject* pctx = slot_at(p, g_off.r_ctx);
        PyObject* pidx = slot_at(p, g_off.r_op_idx);
        PyObject* pslot = slot_at(p, g_off.r_slot);
        PyObject* preq = slot_at(p, g_off.r_requires_grad);
        if (!pctx || !pidx || !pslot || !preq) {
          verdict = 2;
        } else if (pctx != ctx || !wire_is(w, 3, s_op)) {
          verdict = 0;
        } else {
          int a = eq_obj(PyTuple_GET_ITEM(w, 1), pidx);
          int b = a == 1 ? eq_obj(PyTuple_GET_ITEM(w, 2), pslot) : a;
          if (b != 1) {
            verdict = b < 0 ? 2 : 0;
          } else {
            int t = PyObject_IsTrue(preq);
            if (t < 0) verdict = 2;
            else if (t) req = true;
          }
        }
        Py_DECREF(p);
        continue;
      }
    } else if (is_torch(x)) {
      p = Py_NewRef(x);
    } else {
      verdict = 0;
      break;
    }
    // an external input: ("in", idx) at the index it has or gets
    if (!wire_is(w, 2, s_in)) {
      Py_DECREF(p);
      verdict = 0;
      break;
    }
    Py_ssize_t widx = PyLong_AsSsize_t(PyTuple_GET_ITEM(w, 1));
    if (widx == -1 && PyErr_Occurred()) {
      Py_DECREF(p);
      verdict = 2;
      break;
    }
    Py_ssize_t idx = -1;
    PyObject* idkey = PyLong_FromVoidPtr(x);
    PyObject* idxo = idkey ? PyDict_GetItemWithError(seg.in_ids, idkey)
                           : nullptr;
    Py_XDECREF(idkey);
    if (PyErr_Occurred()) {
      Py_DECREF(p);
      verdict = 2;
      break;
    }
    if (idxo) {
      idx = PyLong_AsSsize_t(idxo);
      if (idx < 0 || idx >= n_reg ||
          PyList_GET_ITEM(seg.in_vals, idx) != p) {
        PyErr_Clear();
        idx = -1;
      }
    }
    if (idx < 0) {
      for (size_t k = 0; k < new_ext.size(); ++k) {
        if (new_ext[k].first == x && new_ext[k].second == p) {
          idx = n_reg + (Py_ssize_t)k;
          break;
        }
      }
    }
    bool fresh = false;
    if (idx < 0) {
      idx = n_reg + (Py_ssize_t)new_ext.size();
      if (!PyTuple_Check(in_sig) || idx >= PyTuple_GET_SIZE(in_sig)) {
        Py_DECREF(p);
        verdict = 0;
        break;
      }
      int m = meta_equals(p, PyTuple_GET_ITEM(in_sig, idx));
      if (m != 1) {
        Py_DECREF(p);
        verdict = m < 0 ? 2 : 0;
        break;
      }
      fresh = true;
    }
    if (widx != idx) {
      Py_DECREF(p);
      verdict = 0;
      break;
    }
    PyObject* rg = PyObject_GetAttr(p, s_requires_grad);
    int t = rg ? PyObject_IsTrue(rg) : -1;
    Py_XDECREF(rg);
    if (t < 0) {
      Py_DECREF(p);
      verdict = 2;
      break;
    }
    if (t) req = true;
    if (fresh) {
      new_ext.emplace_back(x, p);  // keeps the reference to p
    } else {
      Py_DECREF(p);
    }
  }
  if (verdict == 1 && ((req && grad == Py_True) != (s_req == Py_True))) {
    verdict = 0;
  }
  if (verdict != 1) {
    for (auto& e : new_ext) Py_DECREF(e.second);
    Py_DECREF(kvals);
    Py_DECREF(amp);
    Py_DECREF(amp_key);
    if (verdict == 0) {
      PyErr_Clear();
      return miss();
    }
    if (verdict == -1) return nullptr;
    return punt();
  }

  // ---- commit: everything matched, nothing was changed above
  bool ok = true;
  for (size_t k = 0; k < new_ext.size(); ++k) {
    PyObject* x = new_ext[k].first;
    PyObject* p = new_ext[k].second;
    if (ok) {
      PyObject* idkey = PyLong_FromVoidPtr(x);
      PyObject* idxo = PyLong_FromSsize_t(PyList_GET_SIZE(seg.in_vals));
      PyObject* wr = PyWeakref_NewRef(x, nullptr);
      ok = idkey && idxo && wr &&
           PyDict_SetItem(seg.in_ids, idkey, idxo) == 0 &&
           PyList_Append(seg.in_tensors, wr) == 0 &&
           (!seg.pinned || PyList_Append(seg.in_pins, x) == 0) &&
           PyList_Append(seg.in_vals, p) == 0;
      Py_XDECREF(idkey);
      Py_XDECREF(idxo);
      Py_XDECREF(wr);
    }
    Py_DECREF(p);
  }
  Py_ssize_t n_outs = PyTuple_GET_SIZE(out_metas);
  PyObject* op_idx = ok ? PyLong_FromSsize_t(PyList_GET_SIZE(seg.pending))
                        : nullptr;
  PyObject* out_refs = ok ? PyList_New(n_outs) : nullptr;
  PyObject* outs = ok ? PyList_New(n_outs) : nullptr;
  ok = op_idx && out_refs && outs;
  for (Py_ssize_t k = 0; ok && k < n_outs; ++k) {
    PyObject* m = PyTuple_GET_ITEM(out_metas, k);
    if (!PyTuple_Check(m) || PyTuple_GET_SIZE(m) != 4) {
      PyErr_SetString(PyExc_TypeError, "malformed output metadata");
      ok = false;
      break;
    }
    PyObject* slot = PyLong_FromSsize_t(k);
    PyObject* trefs = PyList_New(0);
    PyObject* ref = slot && trefs
                        ? ((PyTypeObject*)g_lazyref_t)
                              ->tp_alloc((PyTypeObject*)g_lazyref_t, 0)
                        : nullptr;
    ok = ref && set_slot(ref, g_off.r_ctx, "ctx", ctx) &&
         set_slot(ref, g_off.r_op_idx, "op_idx", op_idx) &&
         set_slot(ref, g_off.r_slot, "slot", slot) &&
         set_slot(ref, g_off.r_shape, "shape", PyTuple_GET_ITEM(m, 0)) &&
         set_slot(ref, g_off.r_dtype, "dtype", PyTuple_GET_ITEM(m, 1)) &&
         set_slot(ref, g_off.r_device, "device", PyTuple_GET_ITEM(m, 2)) &&
         set_slot(ref, g_off.r_requires_grad, "requires_grad",
                  PyTuple_GET_ITEM(m, 3)) &&
         set_slot(ref, g_off.r_trefs, "trefs", trefs);
    PyObject* t = ok ? ((PyTypeObject*)g_tensor_t)
                           ->tp_alloc((PyTypeObject*)g_tensor_t, 0)
                     : nullptr;
    ok = ok && t && set_slot(t, g_off.t_payload, "_payload", ref) &&
         set_slot(t, g_off.t_name, "name", Py_None) &&
         set_slot(t, g_off.t_persistable, "persistable", Py_False);
    if (ok) {
      PyObject* twr = PyWeakref_NewRef(t, nullptr);
      ok = twr && PyList_Append(trefs, twr) == 0;
      Py_XDECREF(twr);
    }
    if (ok) {
      PyList_SET_ITEM(out_refs, k, Py_NewRef(ref));
      PyList_SET_ITEM(outs, k, Py_NewRef(t));
    }
    Py_XDECREF(slot);
    Py_XDECREF(trefs);
    Py_XDECREF(ref);
    Py_XDECREF(t);
  }
  PyObject* pop = ok ? ((PyTypeObject*)g_pending_t)
                           ->tp_alloc((PyTypeObject*)g_pending_t, 0)
                     : nullptr;
  PyObject* n_outs_o = pop ? PyLong_FromSsize_t(n_outs) : nullptr;
  ok = ok && pop && n_outs_o && set_slot(pop, g_off.p_name, "name", name) &&
       set_slot(pop, g_off.p_fn, "fn", fn) &&
       set_slot(pop, g_off.p_attrs, "attrs", attrs) &&
       set_slot(pop, g_off.p_kvals, "kvals", kvals) &&
       set_slot(pop, g_off.p_wiring, "wiring", wiring) &&
       set_slot(pop, g_off.p_out_refs, "out_refs", out_refs) &&
       set_slot(pop, g_off.p_n_outs, "n_outs", n_outs_o) &&
       set_slot(pop, g_off.p_multi, "multi", multi) &&
       set_slot(pop, g_off.p_grad, "grad", grad) &&
       set_slot(pop, g_off.p_amp, "amp", amp) &&
       set_slot(pop, g_off.p_amp_key, "amp_key", amp_key) &&
       set_slot(pop, g_off.p_req, "req", s_req) &&
       PyList_Append(seg.pending, pop) == 0 &&
       PyList_Append(seg.sig_ops, entry) == 0;
  Py_XDECREF(pop);
  Py_XDECREF(n_outs_o);
  Py_XDECREF(op_idx);
  Py_XDECREF(out_refs);
  Py_DECREF(kvals);
  Py_DECREF(amp);
  Py_DECREF(amp_key);
  if (!ok) {
    Py_XDECREF(outs);
    return nullptr;
  }
  if (multi == Py_None) {
    PyObject* r = Py_NewRef(PyList_GET_ITEM(outs, 0));
    Py_DECREF(outs);
    return r;
  }
  PyObject* r = PyObject_CallOneArg(multi, outs);
  Py_DECREF(outs);
  return r;
}

bool add_to_attr(PyObject* owner, PyObject* name, PyObject* n) {
  PyObject* cur = PyObject_GetAttr(owner, name);
  if (!cur) return false;
  PyObject* nv = PyNumber_Add(cur, n);
  Py_DECREF(cur);
  if (!nv) return false;
  int rc = PyObject_SetAttr(owner, name, nv);
  Py_DECREF(nv);
  return rc == 0;
}

// skel_record(ctx, ctups, in_sig, name, fn, inputs, attrs): one record
// replayed at ctx._skel_pos; on a match the cursor and the counters
// (ctx._fast_ops, ctx.ops_recorded, lazy.FAST_OPS) advance
PyObject* skel_record(PyObject*, PyObject* const* a, Py_ssize_t n) {
  if (n != 7) {
    PyErr_SetString(PyExc_TypeError, "skel_record expects 7 arguments");
    return nullptr;
  }
  PyObject *ctx = a[0], *ctups = a[1], *in_sig = a[2], *name = a[3],
           *fn = a[4], *inputs = a[5], *attrs = a[6];
  if (!g_lazyref_t || !PyList_Check(ctups) || !PyTuple_Check(inputs)) {
    return punt();
  }
  PyObject* pos_o = PyObject_GetAttr(ctx, s_skel_pos);
  if (!pos_o) return punt();
  Py_ssize_t pos = PyLong_AsSsize_t(pos_o);
  Py_DECREF(pos_o);
  if (pos < 0) return punt();
  if (pos >= PyList_GET_SIZE(ctups)) return miss();
  PyObject* ctup = PyList_GET_ITEM(ctups, pos);
  if (!PyTuple_Check(ctup) || PyTuple_GET_SIZE(ctup) != kCtupSize) {
    return punt();
  }
  const char* names[6] = {"_in_ids",  "_in_tensors", "_in_vals",
                          "_in_pins", "pending",     "_sig_ops"};
  PyObject* objs[6] = {nullptr};
  bool ok = true;
  for (int i = 0; i < 6; ++i) {
    objs[i] = PyObject_GetAttrString(ctx, names[i]);
    if (!objs[i] || (i == 0 ? !PyDict_Check(objs[i])
                            : !PyList_Check(objs[i]))) {
      ok = false;
    }
  }
  PyObject* on_flush = ok ? PyObject_GetAttrString(ctx, "on_flush")
                          : nullptr;
  PyObject* r;
  if (!ok || !on_flush) {
    r = punt();
  } else {
    Seg seg{objs[0], objs[1], objs[2], objs[3], objs[4], objs[5],
            on_flush != Py_None};
    r = replay_one(ctx, ctup, in_sig, name, fn, &PyTuple_GET_ITEM(inputs, 0),
                   PyTuple_GET_SIZE(inputs), attrs, seg);
  }
  Py_XDECREF(on_flush);
  for (PyObject* o : objs) Py_XDECREF(o);
  if (!r || r == Py_None || r == Py_NotImplemented) return r;
  PyObject* next = PyLong_FromSsize_t(pos + 1);
  bool done = next && PyObject_SetAttr(ctx, s_skel_pos, next) == 0 &&
              add_to_attr(ctx, s_fast_ops, g_one) &&
              add_to_attr(ctx, s_ops_recorded, g_one) &&
              add_to_attr(g_lazy_mod, s_FAST_OPS, g_one);
  Py_XDECREF(next);
  if (!done) {
    Py_DECREF(r);
    return nullptr;
  }
  return r;
}

// ------------------------------------------------------------ driver

// the cell emptied (lazy._drive_retire): the driver wrote the context's
// cursor and counters at each op, so nothing is left to write back
void drive_retire(PyObject* drv) {
  if (PyList_GET_SIZE(g_drive_cell) > 0 &&
      PyList_GET_ITEM(g_drive_cell, 0) == drv) {
    PyList_SetItem(g_drive_cell, 0, Py_NewRef(Py_None));
  }
}

// drive_record(drv, name, fn, inputs, attrs): the outputs of a driven op,
// or None (the driver retired, or another thread called: dispatch.apply
// takes the ordinary path, which judges the op again in full)
PyObject* drive_record(PyObject*, PyObject* const* a, Py_ssize_t n) {
  if (n != 5) {
    PyErr_SetString(PyExc_TypeError, "drive_record expects 5 arguments");
    return nullptr;
  }
  PyObject *drv = a[0], *name = a[1], *fn = a[2], *inputs = a[3],
           *attrs = a[4];
  if (!g_drive_ok || Py_TYPE(drv) != (PyTypeObject*)g_drive_t ||
      !PyTuple_Check(inputs) || !PyDict_Check(attrs)) {
    if (g_drive_cell && PyList_GET_SIZE(g_drive_cell) > 0) {
      PyList_SetItem(g_drive_cell, 0, Py_NewRef(Py_None));
    }
    Py_RETURN_NONE;
  }
  // another thread's op: leave this thread's drive as it is
  PyObject* tid = slot_at(drv, g_d.tid);
  if (!tid || PyLong_AsUnsignedLong(tid) != PyThread_get_thread_ident()) {
    PyErr_Clear();
    Py_RETURN_NONE;
  }
  PyObject* gen = slot_at(drv, g_d.gen);
  PyObject* cell_gen = PyList_GET_SIZE(g_gen_cell) > 0
                           ? PyList_GET_ITEM(g_gen_cell, 0)
                           : nullptr;
  PyObject* hook = module_attr(g_dispatch, s_STATIC_HOOK);
  if (!gen || !cell_gen || eq_obj(gen, cell_gen) != 1 ||
      (hook && hook != Py_None)) {
    PyErr_Clear();
    drive_retire(drv);
    Py_RETURN_NONE;
  }
  PyObject* ctups = slot_at(drv, g_d.ctups);
  PyObject* pos_o = slot_at(drv, g_d.pos);
  PyObject* pending = slot_at(drv, g_d.pending);
  Py_ssize_t pos = pos_o ? PyLong_AsSsize_t(pos_o) : -1;
  if (!ctups || !pending || !PyList_Check(ctups) || !PyList_Check(pending) ||
      pos <= 0 || pos >= PyList_GET_SIZE(ctups) ||
      PyList_GET_SIZE(pending) != pos) {
    PyErr_Clear();
    drive_retire(drv);
    Py_RETURN_NONE;
  }
  // dispatch.apply records only a call with a Tensor among its inputs
  Py_ssize_t n_in = PyTuple_GET_SIZE(inputs);
  bool eager = false;
  for (Py_ssize_t i = 0; i < n_in && !eager; ++i) {
    eager = is_tensor(PyTuple_GET_ITEM(inputs, i));
  }
  PyObject* ctup = PyList_GET_ITEM(ctups, pos);
  if (!eager || n_in > kMaxInputs || !PyTuple_Check(ctup) ||
      PyTuple_GET_SIZE(ctup) != kCtupSize) {
    drive_retire(drv);
    Py_RETURN_NONE;
  }
  PyObject* ctx = slot_at(drv, g_d.ctx);
  PyObject* in_sig = slot_at(drv, g_d.in_sig);
  PyObject* pinned = slot_at(drv, g_d.pinned);
  Seg seg{slot_at(drv, g_d.in_ids),  slot_at(drv, g_d.in_tensors),
          slot_at(drv, g_d.in_vals), slot_at(drv, g_d.in_pins), pending,
          slot_at(drv, g_d.sig_ops), pinned == Py_True};
  if (!ctx || !in_sig || !pinned || !seg.in_ids || !seg.in_tensors ||
      !seg.in_vals || !seg.in_pins || !seg.sig_ops) {
    drive_retire(drv);
    Py_RETURN_NONE;
  }
  Py_INCREF(drv);  // a flush below may empty the cell that holds it
  PyObject* r = replay_one(ctx, ctup, in_sig, name, fn,
                           &PyTuple_GET_ITEM(inputs, 0), n_in, attrs, seg);
  if (!r || r == Py_None || r == Py_NotImplemented) {
    drive_retire(drv);
    Py_DECREF(drv);
    if (r == Py_NotImplemented) {
      Py_DECREF(r);
      Py_RETURN_NONE;
    }
    return r;
  }
  // the cursor and the counters advance as skel_record advances them, so
  // every reader sees them current while the driver is armed
  PyObject* next = PyLong_FromSsize_t(pos + 1);
  bool done = next && PyObject_SetAttr(ctx, s_skel_pos, next) == 0 &&
              add_to_attr(ctx, s_fast_ops, g_one) &&
              add_to_attr(ctx, s_ops_recorded, g_one) &&
              add_to_attr(g_lazy_mod, s_FAST_OPS, g_one);
  if (!done) {
    Py_XDECREF(next);
    Py_DECREF(r);
    drive_retire(drv);
    Py_DECREF(drv);
    return nullptr;
  }
  set_slot(drv, g_d.pos, "pos", next);
  Py_DECREF(next);
  // CaptureContext.maybe_cap_flush, then the plan's end
  PyObject* cap_o = slot_at(drv, g_d.cap);
  Py_ssize_t cap = cap_o ? PyLong_AsSsize_t(cap_o) : PY_SSIZE_T_MAX;
  if (cap == -1 && PyErr_Occurred()) {
    PyErr_Clear();
    cap = PY_SSIZE_T_MAX;
  }
  if (PyList_GET_SIZE(pending) >= cap) {
    drive_retire(drv);
    PyObject* fr = PyObject_CallMethodOneArg(ctx, s_flush, s_segment_cap);
    if (!fr) {
      Py_DECREF(r);
      Py_DECREF(drv);
      return nullptr;
    }
    Py_DECREF(fr);
  } else if (pos + 1 >= PyList_GET_SIZE(ctups)) {
    drive_retire(drv);  // the plan is complete; the seal comes later
  }
  Py_DECREF(drv);
  return r;
}

// bind_drive(_DriveState, gen_cell, drive_cell) -> bool: False (the driver
// stays off) when a _DriveState slot does not resolve
PyObject* bind_drive(PyObject*, PyObject* args) {
  PyObject *dt, *gen_cell, *drive_cell;
  if (!PyArg_ParseTuple(args, "O!O!O!", &PyType_Type, &dt, &PyList_Type,
                        &gen_cell, &PyList_Type, &drive_cell)) {
    return nullptr;
  }
  set_ref(&g_drive_t, dt);
  set_ref(&g_gen_cell, gen_cell);
  set_ref(&g_drive_cell, drive_cell);
  struct Slot {
    Py_ssize_t* off;
    const char* name;
  };
  const Slot slots[] = {
      {&g_d.ctx, "ctx"},         {&g_d.ctups, "ctups"},
      {&g_d.in_sig, "in_sig"},   {&g_d.in_ids, "in_ids"},
      {&g_d.in_tensors, "in_tensors"}, {&g_d.in_vals, "in_vals"},
      {&g_d.in_pins, "in_pins"}, {&g_d.pending, "pending"},
      {&g_d.sig_ops, "sig_ops"}, {&g_d.pinned, "pinned"},
      {&g_d.pos, "pos"},         {&g_d.gen, "gen"},
      {&g_d.cap, "cap"},         {&g_d.tid, "tid"}};
  bool ok = g_lazyref_t != nullptr;
  for (const Slot& s : slots) {
    *s.off = slot_offset(dt, s.name);
    if (*s.off < 0) ok = false;
  }
  g_drive_ok = ok;
  return PyBool_FromLong(ok);
}

PyMethodDef methods[] = {
    {"attrs_key", attrs_key, METH_O,
     "The interned sorted (name, constant key) tuple of an op's attrs; "
     "None when a value needs the Python key."},
    {"sig_entry", sig_entry, METH_O,
     "Intern one segment-signature entry in the bound pool (cleared past "
     "65536 entries)."},
    {"meta_get", (PyCFunction)(void (*)())meta_get, METH_FASTCALL,
     "The record-time metadata cache's entry, or None."},
    {"meta_put", (PyCFunction)(void (*)())meta_put, METH_FASTCALL,
     "Insert one entry in the record-time metadata cache."},
    {"meta_clear", meta_clear, METH_NOARGS,
     "Empty the record-time metadata cache."},
    {"intern_sizes", intern_sizes, METH_NOARGS,
     "Sizes of the native pools and caches."},
    {"bind_types", bind_types, METH_VARARGS,
     "Register the classes and handles the replay reads and makes."},
    {"skel_record", (PyCFunction)(void (*)())skel_record, METH_FASTCALL,
     "One record replayed against the armed skeleton: the outputs, None "
     "on a mismatch, NotImplemented where C cannot judge."},
    {"bind_drive", bind_drive, METH_VARARGS,
     "Register the whole-step driver's state class and cells."},
    {"drive_record", (PyCFunction)(void (*)())drive_record, METH_FASTCALL,
     "One op of an armed step plan: its outputs, or None after the driver "
     "retired."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "pt_eager_core",
                      "The native record core and whole-step driver.", -1,
                      methods};

PyObject* intern(const char* s) { return PyUnicode_InternFromString(s); }

}  // namespace

PyMODINIT_FUNC PyInit_pt_eager_core(void) {
  g_meta_cache = PyDict_New();
  g_atoms = PyDict_New();
  g_attrs_pool = PyDict_New();
  g_one = PyLong_FromLong(1);
  if (!g_meta_cache || !g_atoms || !g_attrs_pool || !g_one) return nullptr;
  s_payload = intern("_payload");
  s_shape = intern("shape");
  s_dtype = intern("dtype");
  s_device = intern("device");
  s_requires_grad = intern("requires_grad");
  s_skel_pos = intern("_skel_pos");
  s_fast_ops = intern("_fast_ops");
  s_ops_recorded = intern("ops_recorded");
  s_FAST_OPS = intern("FAST_OPS");
  s_amp = intern("amp");
  s_key = intern("key");
  s_AMP_HOOK = intern("AMP_HOOK");
  s_STATIC_HOOK = intern("STATIC_HOOK");
  s_flush = intern("flush");
  s_segment_cap = intern("segment_cap");
  s_O0 = intern("O0");
  s_f = intern("f");
  s_NoneType = intern("NoneType");
  s_bool = intern("bool");
  s_int = intern("int");
  s_str = intern("str");
  s_bytes = intern("bytes");
  s_tuple = intern("tuple");
  s_list = intern("list");
  s_dtype_tag = intern("dtype");
  s_in = intern("in");
  s_op = intern("op");
  return PyModule_Create(&module);
}
