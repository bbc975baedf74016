// Model/tensor C surface (reference role: the model-building half of
// include/flexflow/flexflow_c.h — flexflow_config_create / flexflow_model_
// create / flexflow_tensor_create / flexflow_model_add_dense etc.).
//
// TPU-native split: C callers BUILD the model (shape inference + cost
// descriptors live here), run the native Unity search over it, and export a
// JSON spec; the Python runtime (flexflow_tpu.native.c_model) loads the spec
// into a real FFModel for jax execution. Embedding C programs thus get the
// full build->search->train loop without a Python dependency at build time.
#include "ffcore.h"

#include <cmath>
#include <cstring>
#include <map>
#include <memory>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

namespace ffcore {
namespace cmodel {

struct COp {
  int64_t guid;
  std::string type;
  std::string name;
  std::vector<int64_t> inputs;             // tensor guids
  std::map<std::string, std::string> params;
  std::vector<int64_t> outputs;            // tensor guids
};

struct CTensor {
  int64_t guid;
  std::vector<int64_t> dims;
  std::string dtype = "float32";
  int64_t owner = -1;  // op guid
};

struct CModel {
  int batch = 1;
  std::map<std::string, std::string> config;
  std::vector<COp> ops;
  std::map<int64_t, CTensor> tensors;
  int64_t next_guid = 1;
  std::string last_error;

  CTensor& tensor(int64_t guid) {
    auto it = tensors.find(guid);
    if (it == tensors.end())
      throw std::runtime_error("unknown tensor guid " +
                               std::to_string(guid));
    return it->second;
  }

  int64_t add_tensor(std::vector<int64_t> dims, const std::string& dtype,
                     int64_t owner) {
    CTensor t;
    t.guid = next_guid++;
    t.dims = std::move(dims);
    t.dtype = dtype;
    t.owner = owner;
    tensors[t.guid] = t;
    return t.guid;
  }

  COp& add_op(const std::string& type, std::vector<int64_t> inputs,
              std::map<std::string, std::string> params) {
    COp op;
    op.guid = next_guid++;
    op.type = type;
    op.name = type + "_c" + std::to_string(op.guid);
    op.inputs = std::move(inputs);
    op.params = std::move(params);
    ops.push_back(op);
    return ops.back();
  }
};

static int64_t numel(const std::vector<int64_t>& d) {
  int64_t n = 1;
  for (int64_t x : d) n *= x;
  return n;
}

// ---- shape inference + flops per op type (mirrors the Python ops') ------
struct OpInfo {
  std::vector<int64_t> out_dims;
  double flops = 0.0;
  double weight_bytes = 0.0;
  bool tp_capable = false;
  int64_t tp_divisor = 0;
};

static OpInfo infer(CModel& m, const COp& op) {
  auto geti = [&](const char* k, int64_t dflt = 0) {
    auto it = op.params.find(k);
    return it == op.params.end() ? dflt : std::stoll(it->second);
  };
  // required params / input arity / rank checks throw (the C ABI turns
  // them into -1 + last_error) instead of UB or SIGFPE
  auto need = [&](const char* k) {
    auto it = op.params.find(k);
    if (it == op.params.end())
      throw std::runtime_error("op " + op.type + ": missing param " + k);
    int64_t v = std::stoll(it->second);
    if (v <= 0)
      throw std::runtime_error("op " + op.type + ": param " +
                               std::string(k) + " must be > 0");
    return v;
  };
  auto need_inputs = [&](size_t n) {
    if (op.inputs.size() < n)
      throw std::runtime_error("op " + op.type + " needs " +
                               std::to_string(n) + " inputs, got " +
                               std::to_string(op.inputs.size()));
  };
  need_inputs(1);
  const auto& in0 = m.tensor(op.inputs[0]);
  auto need_rank = [&](size_t r) {
    if (in0.dims.size() < r)
      throw std::runtime_error("op " + op.type + ": input rank " +
                               std::to_string(in0.dims.size()) +
                               " < required " + std::to_string(r));
  };
  need_rank(1);
  {
    auto act = op.params.find("activation");
    if (act != op.params.end() && act->second != "" &&
        act->second != "none" && act->second != "relu" &&
        act->second != "sigmoid" && act->second != "tanh" &&
        act->second != "gelu")
      throw std::runtime_error("op " + op.type +
                               ": unsupported activation " + act->second);
  }
  OpInfo r;
  if (op.type == "dense") {
    int64_t out = need("out_dim");
    int64_t in_f = in0.dims.back();
    r.out_dims = in0.dims;
    r.out_dims.back() = out;
    int64_t rows = numel(in0.dims) / in_f;
    r.flops = 2.0 * rows * in_f * out;
    r.weight_bytes = 4.0 * (in_f * out + out);
    r.tp_capable = true;
    r.tp_divisor = out;
  } else if (op.type == "conv2d") {
    need_rank(4);
    int64_t oc = need("out_channels"), kh = need("kernel_h"),
            kw = need("kernel_w"), sh = need("stride_h"),
            sw = need("stride_w"), ph = geti("padding_h"),
            pw = geti("padding_w"), groups = std::max<int64_t>(1, geti("groups", 1));
    int64_t b = in0.dims[0], ic = in0.dims[1], h = in0.dims[2],
            w = in0.dims[3];
    int64_t oh = (h + 2 * ph - kh) / sh + 1, ow = (w + 2 * pw - kw) / sw + 1;
    if (oh <= 0 || ow <= 0)
      throw std::runtime_error("conv2d: kernel exceeds padded input (" +
                               std::to_string(oh) + "x" +
                               std::to_string(ow) + " output)");
    r.out_dims = {b, oc, oh, ow};
    r.flops = 2.0 * b * oc * oh * ow * (ic / groups) * kh * kw;
    r.weight_bytes = 4.0 * (oc * (ic / groups) * kh * kw + oc);
  } else if (op.type == "pool2d") {
    need_rank(4);
    int64_t kh = need("kernel_h"), kw = need("kernel_w"),
            sh = need("stride_h"), sw = need("stride_w"),
            ph = geti("padding_h"), pw = geti("padding_w");
    int64_t b = in0.dims[0], c = in0.dims[1], h = in0.dims[2],
            w = in0.dims[3];
    int64_t oh = (h + 2 * ph - kh) / sh + 1, ow = (w + 2 * pw - kw) / sw + 1;
    if (oh <= 0 || ow <= 0)
      throw std::runtime_error("pool2d: kernel exceeds padded input");
    r.out_dims = {b, c, oh, ow};
  } else if (op.type == "flat") {
    r.out_dims = {in0.dims[0], numel(in0.dims) / in0.dims[0]};
  } else if (op.type == "embedding") {
    int64_t dim = need("out_dim");
    r.out_dims = in0.dims;
    r.out_dims.push_back(dim);
    r.weight_bytes = 4.0 * need("num_entries") * dim;
    r.tp_capable = true;
    r.tp_divisor = dim;
  } else if (op.type == "multihead_attention") {
    need_rank(3);
    int64_t e = need("embed_dim"), heads = need("num_heads");
    int64_t b = in0.dims[0], l = in0.dims[1], d = in0.dims[2];
    r.out_dims = {b, l, e};
    int64_t hd = e / heads;
    r.flops = 2.0 * b * heads *
              (l * d * hd * 3 + l * hd * e + 2.0 * l * l * hd);
    r.weight_bytes = 4.0 * (3.0 * d * e + e * e + 3 * e + e);
    r.tp_capable = true;
    r.tp_divisor = heads;
  } else if (op.type == "concat") {
    int64_t axis = geti("axis");
    r.out_dims = in0.dims;
    if (axis < 0) axis += (int64_t)r.out_dims.size();
    if (axis < 0 || axis >= (int64_t)r.out_dims.size())
      throw std::runtime_error("concat: axis out of range for rank " +
                               std::to_string(r.out_dims.size()));
    int64_t total = 0;
    for (int64_t g : op.inputs) {
      const auto& t = m.tensor(g);
      if ((int64_t)t.dims.size() <= axis)
        throw std::runtime_error("concat: input rank too small for axis");
      total += t.dims[axis];
    }
    r.out_dims[axis] = total;
  } else if (op.type == "batch_matmul") {
    need_inputs(2);
    need_rank(2);
    const auto& in1 = m.tensor(op.inputs[1]);
    if (in1.dims.size() < 2)
      throw std::runtime_error("batch_matmul: second input rank < 2");
    r.out_dims = in0.dims;
    r.out_dims.back() = in1.dims.back();
    int64_t batch = numel(in0.dims) / (in0.dims[in0.dims.size() - 2] *
                                       in0.dims.back());
    r.flops = 2.0 * batch * in0.dims[in0.dims.size() - 2] * in0.dims.back() *
              in1.dims.back();
    r.tp_capable = true;
  } else if (op.type == "layer_norm" || op.type == "batch_norm" ||
             op.type == "softmax" || op.type == "dropout" ||
             op.type == "relu" || op.type == "sigmoid" ||
             op.type == "tanh" || op.type == "gelu" ||
             op.type == "identity") {
    r.out_dims = in0.dims;
    if (op.type == "layer_norm" || op.type == "batch_norm")
      r.weight_bytes = 4.0 * 2 * in0.dims.back();
  } else if (op.type == "add" || op.type == "subtract" ||
             op.type == "multiply") {
    need_inputs(2);
    r.out_dims = in0.dims;
  } else {
    throw std::runtime_error("unsupported C-API op type: " + op.type);
  }
  return r;
}

static std::string json_escape(const std::string& s) {
  std::string out;
  char buf[8];
  for (unsigned char c : s) {
    if (c == '"' || c == '\\') {
      out += '\\';
      out += (char)c;
    } else if (c < 0x20) {  // control chars -> \u00XX (valid JSON)
      snprintf(buf, sizeof buf, "\\u%04x", c);
      out += buf;
    } else {
      out += (char)c;
    }
  }
  return out;
}

static std::string export_json(CModel& m) {
  std::ostringstream o;
  o.precision(17);
  o << "{\"format\": \"flexflow_tpu_c_model\", \"version\": 1,\n";
  o << " \"config\": {\"batch_size\": " << m.batch;
  for (const auto& [k, v] : m.config)
    o << ", \"" << json_escape(k) << "\": \"" << json_escape(v) << "\"";
  o << "},\n \"ops\": [\n";
  for (size_t i = 0; i < m.ops.size(); ++i) {
    const COp& op = m.ops[i];
    o << "  {\"guid\": " << op.guid << ", \"type\": \"" << op.type
      << "\", \"name\": \"" << op.name << "\", \"inputs\": [";
    for (size_t j = 0; j < op.inputs.size(); ++j)
      o << (j ? ", " : "") << op.inputs[j];
    o << "], \"outputs\": [";
    for (size_t j = 0; j < op.outputs.size(); ++j)
      o << (j ? ", " : "") << op.outputs[j];
    o << "], \"params\": {";
    bool first = true;
    for (const auto& [k, v] : op.params) {
      o << (first ? "" : ", ") << "\"" << json_escape(k) << "\": \""
        << json_escape(v) << "\"";
      first = false;
    }
    o << "}";
    if (op.type == "input") {
      o << ", \"dims\": [";
      const auto& t = m.tensor(op.outputs[0]);
      for (size_t j = 0; j < t.dims.size(); ++j)
        o << (j ? ", " : "") << t.dims[j];
      o << "], \"dtype\": \"" << t.dtype << "\"";
    }
    o << "}" << (i + 1 < m.ops.size() ? "," : "") << "\n";
  }
  o << " ]}\n";
  return o.str();
}

// builds the ffcore search Graph from the C model
static Graph to_graph(CModel& m) {
  Graph g;
  for (const COp& op : m.ops) {
    NodeDesc n;
    n.guid = op.guid;
    if (op.type == "input") {
      n.inert = true;
      g.nodes.push_back(n);
      continue;
    }
    OpInfo info = infer(m, op);
    const auto& out = m.tensor(op.outputs[0]);
    n.flops = info.flops;
    n.weight_bytes = info.weight_bytes;
    n.act_bytes = 4.0 * numel(out.dims);
    n.out_elems = (double)numel(out.dims);
    n.bytes_accessed = n.act_bytes + n.weight_bytes;
    for (int64_t in : op.inputs)
      n.bytes_accessed += 4.0 * numel(m.tensor(in).dims);
    n.dtype_bytes = 4;
    n.tp_capable = info.tp_capable;
    n.tp_divisor = info.tp_divisor;
    g.nodes.push_back(n);
    for (int64_t in : op.inputs) {
      EdgeDesc e;
      const auto& t = m.tensor(in);
      if (t.owner < 0) continue;
      e.src = t.owner;
      e.dst = op.guid;
      e.bytes = 4.0 * numel(t.dims);
      g.edges.push_back(e);
    }
  }
  return g;
}

}  // namespace cmodel
}  // namespace ffcore

// ------------------------------------------------------------------ C ABI
using ffcore::cmodel::CModel;
using ffcore::cmodel::COp;

static char* dup_string(const std::string& s) {
  char* buf = (char*)malloc(s.size() + 1);
  memcpy(buf, s.c_str(), s.size() + 1);
  return buf;
}

extern "C" {

void* ffc_model_create(int batch_size) {
  auto* m = new CModel();
  m->batch = batch_size;
  return m;
}

void ffc_model_destroy(void* h) { delete (CModel*)h; }

const char* ffc_model_last_error(void* h) {
  return ((CModel*)h)->last_error.c_str();
}

void ffc_model_config_set(void* h, const char* key, const char* value) {
  ((CModel*)h)->config[key] = value;
}

// returns the new tensor guid, or -1 on error
int64_t ffc_tensor_create(void* h, int ndims, const int64_t* dims,
                          const char* dtype) {
  auto* m = (CModel*)h;
  try {
    if (ndims < 1 || dims == nullptr)
      throw std::runtime_error("tensor needs ndims >= 1 and a dims array");
    for (int i = 0; i < ndims; ++i)
      if (dims[i] <= 0)
        throw std::runtime_error("tensor dim " + std::to_string(i) +
                                 " must be > 0, got " +
                                 std::to_string(dims[i]));
    std::string dt = dtype ? dtype : "float32";
    if (dt != "float32" && dt != "int32" && dt != "int64" &&
        dt != "bfloat16" && dt != "bool")
      throw std::runtime_error("unsupported dtype: " + dt);
    COp& op = m->add_op("input", {}, {});
    int64_t t = m->add_tensor(std::vector<int64_t>(dims, dims + ndims), dt,
                              op.guid);
    op.outputs.push_back(t);
    return t;
  } catch (const std::exception& e) {
    m->last_error = e.what();
    return -1;
  }
}

// generic op entry: n_inputs tensor guids + "key=value" params (one string,
// ';'-separated). Returns the output tensor guid, or -1 on error.
int64_t ffc_op(void* h, const char* type, int n_inputs,
               const int64_t* inputs, const char* params) {
  auto* m = (CModel*)h;
  try {
    std::map<std::string, std::string> p;
    if (params && *params) {
      std::istringstream ss(params);
      std::string kv;
      while (std::getline(ss, kv, ';')) {
        auto eq = kv.find('=');
        if (eq != std::string::npos)
          p[kv.substr(0, eq)] = kv.substr(eq + 1);
      }
    }
    COp& op = m->add_op(type,
                        std::vector<int64_t>(inputs, inputs + n_inputs),
                        std::move(p));
    ffcore::cmodel::OpInfo info = ffcore::cmodel::infer(*m, op);
    int64_t t = m->add_tensor(info.out_dims, "float32", op.guid);
    op.outputs.push_back(t);
    return t;
  } catch (const std::exception& e) {
    m->last_error = e.what();
    m->ops.pop_back();
    return -1;
  }
}

// tensor introspection: writes up to max_dims dims; returns ndims or -1
int ffc_tensor_ndims(void* h, int64_t guid, int64_t* dims, int max_dims) {
  auto* m = (CModel*)h;
  try {
    const auto& t = m->tensor(guid);
    int n = (int)t.dims.size();
    for (int i = 0; i < n && i < max_dims; ++i) dims[i] = t.dims[i];
    return n;
  } catch (const std::exception& e) {
    m->last_error = e.what();
    return -1;
  }
}

// JSON spec for the Python runtime (flexflow_tpu.native.c_model); caller
// frees with ffc_free
char* ffc_model_export_json(void* h) {
  auto* m = (CModel*)h;
  try {
    return dup_string(ffcore::cmodel::export_json(*m));
  } catch (const std::exception& e) {
    m->last_error = e.what();
    return dup_string(std::string("error ") + e.what());
  }
}

// run the native Unity search over the C-built model; returns the same text
// format as ffc_run's optimize command
char* ffc_model_optimize(void* h, int n_devices, int budget, double alpha) {
  auto* m = (CModel*)h;
  try {
    ffcore::Graph g = ffcore::cmodel::to_graph(*m);
    ffcore::MachineSpec spec;
    ffcore::Options o;
    o.n_devices = n_devices;
    o.batch = m->batch;
    o.budget = budget;
    o.alpha = alpha;
    ffcore::SearchResult r = ffcore::optimize(g, spec, o);
    return dup_string(ffcore::format_search_result(r));
  } catch (const std::exception& e) {
    m->last_error = e.what();
    return dup_string(std::string("error ") + e.what());
  }
}

}  // extern "C"
