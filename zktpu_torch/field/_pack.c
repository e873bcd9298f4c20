/* One pass over a list or tuple of small Python ints into field words.
 *
 * pack_small(seq, out, n, w) writes item k of ``seq`` as row k of the
 * (n, w) uint32 buffer ``out``: its low and high 32 bits, then w - 2 zero
 * words. It takes an item only if it is an int (exactly, or a bool) in
 * [0, 2^64); the caller guarantees 2^64 < p, so such a value is already
 * canonical. It returns the index of the first item it declines, or -1 when
 * all n are packed, and leaves no Python error set. Rows before a declined
 * item are written, the rest are not.
 *
 * It reads Python objects, so it runs holding the interpreter lock (loaded
 * with ctypes.PyDLL).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>

Py_ssize_t pack_small(PyObject *seq, uint32_t *out, Py_ssize_t n, Py_ssize_t w)
{
    PyObject *fast = PySequence_Fast(seq, "pack_small takes a list or tuple");
    if (fast == NULL) {
        PyErr_Clear();
        return 0;
    }
    if (PySequence_Fast_GET_SIZE(fast) != n || w < 2) {
        Py_DECREF(fast);
        return 0;
    }
    PyObject **items = PySequence_Fast_ITEMS(fast);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *v = items[i];
        if (!PyLong_CheckExact(v) && !PyBool_Check(v)) {
            Py_DECREF(fast);
            return i;
        }
        unsigned long long x = PyLong_AsUnsignedLongLong(v);
        if (x == (unsigned long long)-1 && PyErr_Occurred()) {
            PyErr_Clear();  /* negative or at least 2^64 */
            Py_DECREF(fast);
            return i;
        }
        uint32_t *row = out + i * w;
        row[0] = (uint32_t)x;
        row[1] = (uint32_t)(x >> 32);
        for (Py_ssize_t k = 2; k < w; k++)
            row[k] = 0;
    }
    Py_DECREF(fast);
    return -1;
}
