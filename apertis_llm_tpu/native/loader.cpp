// _apertis_native: C++ host-side data loader for the Apertis framework.
//
// The input pipeline's hot path — JSONL parsing, whitespace tokenisation
// against a vocab map, pad/truncate, label masking — runs here with the GIL
// released and a thread pool over file chunks, feeding device batches faster
// than a single host's Python loop can (the reference used torch
// DataLoader worker subprocesses for the same job, pipeline.py:502).
//
// Pure CPython API (no pybind11/numpy headers): results return as
// bytes-like buffers that the Python wrapper views as numpy arrays.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <memory>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
    std::unordered_map<std::string, int32_t> vocab;
    int32_t unk_id = 3;
    int32_t pad_id = 0;
    int32_t model_vocab_size = INT32_MAX;
};

void tokenizer_capsule_destructor(PyObject *capsule) {
    delete static_cast<Tokenizer *>(
        PyCapsule_GetPointer(capsule, "apertis.Tokenizer"));
}

Tokenizer *get_tokenizer(PyObject *capsule) {
    return static_cast<Tokenizer *>(
        PyCapsule_GetPointer(capsule, "apertis.Tokenizer"));
}

// Minimal JSON string-field extractor: finds "key": "..." at the top level
// of one JSONL object and unescapes the value. Returns false if absent.
bool extract_json_string(const std::string &line, const std::string &key,
                         std::string *out) {
    const std::string needle = "\"" + key + "\"";
    size_t pos = line.find(needle);
    if (pos == std::string::npos) return false;
    pos += needle.size();
    while (pos < line.size() && (line[pos] == ' ' || line[pos] == ':')) pos++;
    if (pos >= line.size() || line[pos] != '"') return false;
    pos++;
    out->clear();
    while (pos < line.size()) {
        char c = line[pos];
        if (c == '\\' && pos + 1 < line.size()) {
            char n = line[pos + 1];
            switch (n) {
                case 'n': out->push_back('\n'); break;
                case 't': out->push_back('\t'); break;
                case 'r': out->push_back('\r'); break;
                case '"': out->push_back('"'); break;
                case '\\': out->push_back('\\'); break;
                case '/': out->push_back('/'); break;
                case 'u': {
                    // Keep it simple: decode BMP escapes to UTF-8.
                    if (pos + 5 < line.size()) {
                        unsigned int cp = 0;
                        sscanf(line.c_str() + pos + 2, "%4x", &cp);
                        if (cp < 0x80) {
                            out->push_back(static_cast<char>(cp));
                        } else if (cp < 0x800) {
                            out->push_back(static_cast<char>(0xC0 | (cp >> 6)));
                            out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
                        } else {
                            out->push_back(static_cast<char>(0xE0 | (cp >> 12)));
                            out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
                            out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
                        }
                        pos += 4;
                    }
                    break;
                }
                default: out->push_back(n);
            }
            pos += 2;
            continue;
        }
        if (c == '"') return true;
        out->push_back(c);
        pos++;
    }
    return false;
}

void tokenize_into(const Tokenizer &tok, const std::string &text,
                   int32_t *ids, int32_t *mask, int32_t *labels,
                   int64_t max_len) {
    int64_t n = 0;
    size_t i = 0;
    const size_t len = text.size();
    while (i < len && n < max_len) {
        while (i < len && std::isspace(static_cast<unsigned char>(text[i]))) i++;
        size_t start = i;
        while (i < len && !std::isspace(static_cast<unsigned char>(text[i]))) i++;
        if (i == start) break;
        std::string word = text.substr(start, i - start);
        auto it = tok.vocab.find(word);
        int32_t id = (it != tok.vocab.end()) ? it->second : tok.unk_id;
        if (id >= tok.model_vocab_size) id = tok.unk_id;
        ids[n] = id;
        mask[n] = 1;
        labels[n] = id;
        n++;
    }
    for (; n < max_len; n++) {
        ids[n] = tok.pad_id;
        mask[n] = 0;
        labels[n] = -100;
    }
    // pad tokens appearing in the real text still mask their labels, matching
    // the reference's labels[ids == pad] = -100.
    for (int64_t j = 0; j < max_len; j++) {
        if (ids[j] == tok.pad_id) labels[j] = -100;
    }
}

}  // namespace

// make_tokenizer(vocab_dict, pad_id, unk_id, model_vocab_size) -> capsule
static PyObject *make_tokenizer(PyObject *, PyObject *args) {
    PyObject *vocab_dict;
    int pad_id, unk_id, model_vocab;
    if (!PyArg_ParseTuple(args, "Oiii", &vocab_dict, &pad_id, &unk_id,
                          &model_vocab))
        return nullptr;
    if (!PyDict_Check(vocab_dict)) {
        PyErr_SetString(PyExc_TypeError, "vocab must be a dict");
        return nullptr;
    }
    auto tok = std::make_unique<Tokenizer>();
    tok->pad_id = pad_id;
    tok->unk_id = unk_id;
    tok->model_vocab_size = model_vocab;

    PyObject *key, *value;
    Py_ssize_t pos = 0;
    while (PyDict_Next(vocab_dict, &pos, &key, &value)) {
        const char *k = PyUnicode_AsUTF8(key);
        long v = PyLong_AsLong(value);
        if (k == nullptr || (v == -1 && PyErr_Occurred())) return nullptr;
        tok->vocab.emplace(k, static_cast<int32_t>(v));
    }
    return PyCapsule_New(tok.release(), "apertis.Tokenizer",
                         tokenizer_capsule_destructor);
}

// encode_batch(tokenizer, list_of_texts, max_len, num_threads)
//   -> (ids_bytes, mask_bytes, labels_bytes)  each n*max_len int32
static PyObject *encode_batch(PyObject *, PyObject *args) {
    PyObject *capsule, *texts;
    Py_ssize_t max_len;
    int num_threads;
    if (!PyArg_ParseTuple(args, "OOni", &capsule, &texts, &max_len,
                          &num_threads))
        return nullptr;
    Tokenizer *tok = get_tokenizer(capsule);
    if (tok == nullptr) return nullptr;
    if (!PyList_Check(texts)) {
        PyErr_SetString(PyExc_TypeError, "texts must be a list of str");
        return nullptr;
    }
    const Py_ssize_t n = PyList_GET_SIZE(texts);
    std::vector<std::string> strings(n);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PyList_GET_ITEM(texts, i);
        Py_ssize_t sz;
        const char *s = PyUnicode_AsUTF8AndSize(item, &sz);
        if (s == nullptr) return nullptr;
        strings[i].assign(s, sz);
    }

    PyObject *ids_b = PyBytes_FromStringAndSize(nullptr, n * max_len * 4);
    PyObject *mask_b = PyBytes_FromStringAndSize(nullptr, n * max_len * 4);
    PyObject *labels_b = PyBytes_FromStringAndSize(nullptr, n * max_len * 4);
    if (!ids_b || !mask_b || !labels_b) return nullptr;
    auto *ids = reinterpret_cast<int32_t *>(PyBytes_AS_STRING(ids_b));
    auto *mask = reinterpret_cast<int32_t *>(PyBytes_AS_STRING(mask_b));
    auto *labels = reinterpret_cast<int32_t *>(PyBytes_AS_STRING(labels_b));

    Py_BEGIN_ALLOW_THREADS
    int workers = std::max(1, num_threads);
    std::vector<std::thread> pool;
    std::atomic<Py_ssize_t> next{0};
    for (int w = 0; w < workers; w++) {
        pool.emplace_back([&]() {
            while (true) {
                Py_ssize_t i = next.fetch_add(1);
                if (i >= n) break;
                tokenize_into(*tok, strings[i], ids + i * max_len,
                              mask + i * max_len, labels + i * max_len,
                              max_len);
            }
        });
    }
    for (auto &t : pool) t.join();
    Py_END_ALLOW_THREADS

    return Py_BuildValue("(NNN)", ids_b, mask_b, labels_b);
}

// read_jsonl_field(path, field) -> list of str (skipping bad lines)
static PyObject *read_jsonl_field(PyObject *, PyObject *args) {
    const char *path, *field;
    if (!PyArg_ParseTuple(args, "ss", &path, &field)) return nullptr;

    std::vector<std::string> values;
    bool io_error = false;
    Py_BEGIN_ALLOW_THREADS
    std::ifstream in(path);
    if (!in) {
        io_error = true;
    } else {
        std::string line, value;
        while (std::getline(in, line)) {
            if (line.empty()) continue;
            if (extract_json_string(line, field, &value)) {
                values.push_back(value);
            }
        }
    }
    Py_END_ALLOW_THREADS
    if (io_error) {
        PyErr_Format(PyExc_FileNotFoundError, "cannot open %s", path);
        return nullptr;
    }
    PyObject *list = PyList_New(values.size());
    if (!list) return nullptr;
    for (size_t i = 0; i < values.size(); i++) {
        PyObject *s = PyUnicode_FromStringAndSize(values[i].data(),
                                                  values[i].size());
        if (!s) {
            Py_DECREF(list);
            return nullptr;
        }
        PyList_SET_ITEM(list, i, s);
    }
    return list;
}

static PyMethodDef Methods[] = {
    {"make_tokenizer", make_tokenizer, METH_VARARGS,
     "Build a native whitespace tokenizer from a vocab dict."},
    {"encode_batch", encode_batch, METH_VARARGS,
     "Tokenise texts -> (ids, mask, labels) int32 buffers."},
    {"read_jsonl_field", read_jsonl_field, METH_VARARGS,
     "Extract a string field from every line of a JSONL file."},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_apertis_native",
    "Native host-side data loading for Apertis", -1, Methods,
};

PyMODINIT_FUNC PyInit__apertis_native(void) {
    return PyModule_Create(&moduledef);
}
